"""Array-native orchestration plane.

Three batched twins of the scalar manager orchestration hot loops, all
decision-identical to their scalar oracles:

  * `BatchedReconciler` — per-service slot state for EVERY replicated
    service in one vectorized pass over the columnar task table
    (store/columnar.py hot columns + the `compute_slot_state` census in
    ops/reconcile.py, kernel K18 on `device` from DIFF_THRESHOLD cells):
    runnable-slot census vs spec.replicas, scale-up
    slot fills, scale-down victim ordering, and dirty-slot candidates
    via the spec-version column. Steady services (the overwhelming
    majority of a 100k-service pass) are classified with ZERO object
    reads and ZERO store transactions; only actionable services pay a
    per-service transaction, which re-validates in-tx with the SAME
    decision code the scalar path runs (the bulk_reconcile shape).

  * `batch_should_restart` — the restart gate
    (`RestartSupervisor.should_restart`) vectorized over a batch of
    dead tasks: the condition/job/state ladder is pure array algebra;
    only tasks under a max_attempts policy fall back to the sequential
    history walk, simulating the interleaved `_record` bookkeeping so a
    batch decides bit-identically to N sequential scalar calls.

  * `UpdateWavePlanner` — ONE clock-driven thread schedules dirty-slot
    replacement waves for ALL updating services, replacing the
    thread-per-service `Updater`: parallelism is a per-service budget
    of concurrent slot flips + delay cooldowns, monitor windows and the
    max_failure_ratio verdict use the scalar formulas, and every store
    write rides the SHARED slot-flip helpers in orchestrator/updater.py.
    Spec supersede (a live
    pass re-reads the service each step) and cancel (stop() without a
    terminal status write) keep the scalar semantics.

The decision primitives `fill_slots` / `victim_order` are shared with
the scalar `ReplicatedOrchestrator` — both paths call the same
functions on the same summaries, so victim order and slot fills cannot
drift; the ≥20-seed fuzz in tests/test_torch_batched_orch.py pins that
the SUMMARIES (and therefore the decisions) match too.

The port's copy of the JAX package's `orchestrator/batched.py`. The plane
is always on (the port's store always keeps its columnar mirror); there
is no environment switch.
"""
from __future__ import annotations

import logging
import threading
from collections import Counter
from dataclasses import dataclass, field

import numpy as np

from ..analysis.lockgraph import make_lock
from ..api.types import (
    TaskState,
    UpdateFailureAction,
    UpdateOrder,
    UpdateStatusState,
)
from ..utils.clock import REAL_CLOCK

log = logging.getLogger("swarmkit_tpu_torch.orchestrator.batched")

# plane-wide op counters
stats: Counter = Counter()

# per-service slot-census width bound: a service carrying a slot number
# beyond this falls back to the scalar per-service decision (the dense
# flat census would explode); ordinary slots are 1..replicas
MAX_CENSUS_SLOT = 4096


# ------------------------------------------------------ shared primitives
def fill_slots(used: set, count: int) -> list[int]:
    """Scale-up slot choice: the lowest free slot numbers, from 1
    (replicated/services.go scale-up walk). Shared by the scalar
    reconcile and the batched one — the fill cannot drift."""
    out: list[int] = []
    used = set(used)
    slot_num = 1
    while len(out) < count:
        if slot_num not in used:
            out.append(slot_num)
            used.add(slot_num)
        slot_num += 1
    return out


def victim_order(summaries: dict[int, tuple[bool, list]],
                 excess: int) -> list[int]:
    """Scale-down victim choice, shared by both reconcile paths:
    iteratively drop the slot with (non-running first, busiest node,
    highest slot number), recomputing node load after each pick so ties
    rebalance instead of draining one node. `summaries` maps slot ->
    (any_running, node keys of the slot's tasks); node keys only need
    identity (the scalar passes node-id strings, the batched path vocab
    ints — the arithmetic is identical)."""
    node_load: dict = {}
    for running, nids in summaries.values():
        for nid in nids:
            node_load[nid] = node_load.get(nid, 0) + 1

    def removal_key(item):
        slot, (running, nids) = item
        load = max((node_load.get(n, 0) for n in nids), default=0)
        return (0 if not running else 1, -load, -slot)

    remaining = dict(summaries)
    out: list[int] = []
    for _ in range(min(excess, len(remaining))):
        slot, (running, nids) = min(remaining.items(), key=removal_key)
        del remaining[slot]
        out.append(slot)
        for nid in nids:
            node_load[nid] = max(node_load.get(nid, 1) - 1, 0)
    return out


@dataclass
class ReconcileDecision:
    """One replicated service's reconcile verdict. `dirty_slots` carries
    task OBJECTS (the updater's unit of work); create/victim carry slot
    numbers — application resolves tasks in-tx. `kick_update` flags a
    service whose update status is non-terminal (updating /
    rollback_started) with NO dirty slot left: the update pass must
    still run so it writes its terminal status — the restart supervisor
    can converge the slots on its own (the reference invokes the
    updater on every reconcile; a no-op pass completes the status)."""

    create_slots: list[int] = field(default_factory=list)
    victim_slots: list[int] = field(default_factory=list)
    dirty_slots: list[list] = field(default_factory=list)
    kick_update: bool = False

    @property
    def actionable(self) -> bool:
        return bool(self.create_slots or self.victim_slots)

    @property
    def empty(self) -> bool:
        return not (self.create_slots or self.victim_slots
                    or self.dirty_slots or self.kick_update)


# -------------------------------------------------------- batched reconcile
class BatchedReconciler:
    """The columnar reconciler: classify + decide for many replicated
    services in one array pass. Reads ONLY derived-truth columns
    (store/columnar.py) plus task/service objects for the actionable
    residue; never writes the store (application is the caller's). The
    census runs on `device` (None: the card, raising without one from
    DIFF_THRESHOLD cells; "cpu": the plain PyTorch version)."""

    def __init__(self, store, device=None):
        self.store = store
        self.device = device
        self.stats: Counter = Counter()

    # the vectorized pass -------------------------------------------------
    def decide_many(self, service_ids: list[str],
                    view=None) -> dict[str, ReconcileDecision]:
        """One decision per service id (ids that are not live replicated
        services — deleted, global, pending_delete — are omitted, the
        scalar reconcile's entry gate). Decisions are computed from a
        single consistent columnar snapshot; appliers must re-validate
        in-tx (the scalar decision code IS the re-validation)."""
        stats["decide_passes"] += 1
        self.stats["decide_passes"] += 1
        col = self.store.columnar
        if view is None:
            view = self.store.view()
        out: dict[str, ReconcileDecision] = {}
        if not service_ids:
            return out

        with self.store._lock:
            scol = col.service_cols
            rows = np.fromiter((scol.row_of(sid) for sid in service_ids),
                               np.int64, len(service_ids))
            known = rows >= 0
            in_scope = known.copy()
            r_safe = np.where(known, rows, 0)
            in_scope &= scol.replicated[r_safe] & \
                ~scol.pending_delete[r_safe]
            scope_rows = rows[in_scope]
            scope_ids = [sid for sid, ok in zip(service_ids, in_scope)
                         if ok]
            # ids the columns have never seen: fall back to the scalar
            # per-service decision (they still get a verdict)
            fallback_ids = [sid for sid, k in zip(service_ids, known)
                            if not k]
            self.stats["services_scanned"] += len(scope_ids)
            if len(scope_ids):
                scoped, oversized_ids = self._decide_scope(
                    view, col, scope_ids, scope_rows)
                out.update(scoped)
                fallback_ids.extend(oversized_ids)
        # scalar fallbacks (never-seen ids, oversized slots) run OUTSIDE
        # the store lock: they walk objects and spec-compare, and a
        # commit must not block behind that
        for sid in fallback_ids:
            d = self._decide_scalar(view, sid)
            if d is not None:
                out[sid] = d
                self.stats["scalar_fallbacks"] += 1
        return out

    def _decide_scope(self, view, col, scope_ids, scope_rows):
        from ..ops.reconcile import compute_slot_state

        scol = col.service_cols
        S = len(scope_ids)
        # compact service index over the vocab domain
        inv = np.full(len(col.services), -1, np.int64)
        inv[scope_rows] = np.arange(S)
        wanted = np.zeros(len(col.services), bool)
        wanted[scope_rows] = True

        n_rows = len(col.ids)
        live = col.valid[:n_rows] & \
            (col.desired[:n_rows] <= int(TaskState.RUNNING))
        sel = np.flatnonzero(live)
        svc_vocab = col.service_idx[sel]
        sel = sel[wanted[svc_vocab]]
        self.stats["task_rows_scanned"] += int(sel.size)

        compact = inv[col.service_idx[sel]]
        sl_raw = col.slot[sel]
        replicas = scol.replicas[scope_rows]
        spec_ver = scol.spec_version[scope_rows]

        # services with out-of-range slots (dense census would explode;
        # negative values would WRAP the flat index) take the scalar
        # fallback — deferred to the CALLER, outside the store lock
        oversize_mask = (sl_raw >= MAX_CENSUS_SLOT) | (sl_raw < 0)
        oversized = np.unique(compact[oversize_mask]) \
            if oversize_mask.any() else np.empty(0, np.int64)
        out: dict[str, ReconcileDecision] = {}
        oversized_ids = [scope_ids[ci] for ci in oversized.tolist()]
        if oversized.size:
            keep_svc = np.ones(S, bool)
            keep_svc[oversized] = False
            keep = keep_svc[compact]
            sel, compact, sl_raw = sel[keep], compact[keep], sl_raw[keep]
        else:
            keep_svc = np.ones(S, bool)

        state = col.state[sel]
        runnable = state <= int(TaskState.RUNNING)
        running = state == int(TaskState.RUNNING)
        M = int(sl_raw.max()) + 1 if sl_raw.size else 1
        used_f, slot_runnable_f, slot_running_f, runnable_slots = \
            compute_slot_state(compact, sl_raw, runnable, running, S, M,
                               device=self.device)
        self.stats["census_cells"] += S * M

        # dirty candidates: spec-version mismatch in a RUNNABLE slot —
        # exactly the rows the scalar is_task_dirty would spec-compare
        key = compact * M + sl_raw
        cand = (col.spec_version[sel] != spec_ver[compact]) \
            & slot_runnable_f[key]
        any_cand = np.zeros(S, bool)
        if cand.any():
            np.maximum.at(any_cand, compact[cand], True)

        scale_up = (runnable_slots < replicas) & keep_svc
        scale_down = (runnable_slots > replicas) & keep_svc
        actionable = scale_up | scale_down | (any_cand & keep_svc)
        # non-terminal update status with nothing else to do: the pass
        # must still be kicked so it writes its terminal status
        in_upd = scol.in_update[scope_rows] & keep_svc
        kick_only = in_upd & ~actionable
        for ci in np.flatnonzero(kick_only).tolist():
            out[scope_ids[ci]] = ReconcileDecision(kick_update=True)
        self.stats["services_steady"] += int(S - int(actionable.sum())
                                             - int(kick_only.sum())
                                             - int((~keep_svc).sum()))
        if not actionable.any():
            return out, oversized_ids

        # group task rows by service once for the actionable residue
        order = np.argsort(compact, kind="stable")
        compact_sorted = compact[order]
        bounds = np.searchsorted(compact_sorted,
                                 np.arange(S + 1))
        act_idx = np.flatnonzero(actionable)
        self.stats["services_actionable"] += int(act_idx.size)
        for ci in act_idx.tolist():
            sid = scope_ids[ci]
            rows_s = sel[order[bounds[ci]:bounds[ci + 1]]]
            d = ReconcileDecision()
            base = ci * M
            if scale_up[ci]:
                used = set(np.flatnonzero(
                    used_f[base:base + M]).tolist())
                d.create_slots = fill_slots(
                    used, int(replicas[ci]) - int(runnable_slots[ci]))
            elif scale_down[ci]:
                summaries: dict[int, tuple[bool, list]] = {}
                for r in rows_s.tolist():
                    s_slot = int(col.slot[r])
                    if not slot_runnable_f[base + s_slot]:
                        continue
                    entry = summaries.get(s_slot)
                    if entry is None:
                        entry = (bool(slot_running_f[base + s_slot]), [])
                        summaries[s_slot] = entry
                    nd = int(col.node_idx[r])
                    if nd > 0:
                        entry[1].append(col.nodes.name(nd))
                d.victim_slots = victim_order(
                    summaries,
                    int(runnable_slots[ci]) - int(replicas[ci]))
            if any_cand[ci]:
                d.dirty_slots = self._dirty_residue(
                    view, col, sid, rows_s, cand, sel, order,
                    bounds[ci], bounds[ci + 1], base, M,
                    slot_runnable_f)
            d.kick_update = bool(in_upd[ci]) and not d.dirty_slots
            if not d.empty:
                out[sid] = d
        return out, oversized_ids

    def _dirty_residue(self, view, col, sid, rows_s, cand, sel, order,
                       lo, hi, base, M, slot_runnable_f):
        """Host residue of the dirty check: spec-compare ONLY the
        version-mismatch candidates, then materialize the dirty slots'
        live task lists (the updater's input shape)."""
        from .task import is_task_dirty

        service = view.get_service(sid)
        if service is None:
            return []
        cand_local = cand[order[lo:hi]]
        dirty_slot_nums: set[int] = set()
        for j, r in enumerate(rows_s.tolist()):
            if not cand_local[j]:
                continue
            t = view.get_task(col.ids[r])
            self.stats["object_reads"] += 1
            if t is not None and is_task_dirty(service, t):
                dirty_slot_nums.add(int(col.slot[r]))
        if not dirty_slot_nums:
            return []
        by_slot: dict[int, list] = {s: [] for s in sorted(dirty_slot_nums)}
        for r in rows_s.tolist():
            s_slot = int(col.slot[r])
            if s_slot in by_slot:
                t = view.get_task(col.ids[r])
                self.stats["object_reads"] += 1
                if t is not None:
                    by_slot[s_slot].append(t)
        return [sorted(ts, key=lambda t: t.id)
                for ts in by_slot.values() if ts]

    # scalar fallback ------------------------------------------------------
    def _decide_scalar(self, view, service_id) -> ReconcileDecision | None:
        from .replicated import decide_service
        from .task import is_replicated
        from ..store import by

        service = view.get_service(service_id)
        if service is None or not is_replicated(service) \
                or service.pending_delete:
            return None
        tasks = [t for t in view.find_tasks(by.ByServiceID(service_id))
                 if t.desired_state <= TaskState.RUNNING]
        return decide_service(service, tasks)


# ---------------------------------------------------- batched restart gate
def batch_should_restart(restart, pairs, now: float | None = None):
    """Vectorized `RestartSupervisor.should_restart` over `pairs` =
    [(service, task), ...], decided bit-identically to N sequential
    scalar calls INCLUDING the interleaved `_record` bookkeeping a
    restarting caller performs: grants earlier in the batch count
    against later same-key grants' max_attempts windows (simulated here;
    the caller's subsequent `_record` makes them real). Window pruning
    of the live history matches the scalar side effect. Returns a bool
    ndarray aligned with `pairs`."""
    from ..api.types import RestartCondition
    from .task import is_job

    n = len(pairs)
    grants = np.zeros(n, bool)
    if not n:
        return grants
    stats["restart_gate_batches"] += 1
    if now is None:
        now = restart._clock.time()

    # pure ladder, one pass of array algebra
    state = np.fromiter((int(t.status.state) for _s, t in pairs),
                        np.int32, n)
    cond_none = np.fromiter(
        (s.spec.task.restart.condition == RestartCondition.NONE
         for s, _t in pairs), bool, n)
    cond_on_failure = np.fromiter(
        (s.spec.task.restart.condition == RestartCondition.ON_FAILURE
         for s, _t in pairs), bool, n)
    job = np.fromiter((is_job(s) for s, _t in pairs), bool, n)
    max_attempts = np.fromiter(
        (s.spec.task.restart.max_attempts for s, _t in pairs), np.int64, n)
    complete = state == int(TaskState.COMPLETE)
    maybe = ~(job & complete) & ~cond_none & ~(cond_on_failure & complete)
    grants[:] = maybe

    # history residue: only policies with max_attempts > 0, walked in
    # batch order with simulated records (scalar interleaving)
    residue = np.flatnonzero(maybe & (max_attempts > 0))
    if residue.size:
        sim_total: dict = {}
        sim_times: dict = {}
        for i in residue.tolist():
            service, task = pairs[i]
            policy = service.spec.task.restart
            key = restart._instance_key(task)
            info = restart._history.get(key)
            total = (info.total_restarts if info is not None else 0) \
                + sim_total.get(key, 0)
            if policy.window <= 0:
                if total >= policy.max_attempts:
                    grants[i] = False
                    continue
            else:
                recent = []
                if info is not None:
                    recent = [r for r in info.restarted_instances
                              if now - r.timestamp <= policy.window]
                    info.restarted_instances = recent  # scalar prune
                n_recent = len(recent) + len([
                    t0 for t0 in sim_times.get(key, ())
                    if now - t0 <= policy.window])
                if n_recent >= policy.max_attempts:
                    grants[i] = False
                    continue
            # granted: simulate the _record the caller will perform
            sim_total[key] = sim_total.get(key, 0) + 1
            if policy.window > 0:
                sim_times.setdefault(key, []).append(now)
    return grants


# ------------------------------------------------------ update wave planner
class _SlotFlip:
    __slots__ = ("slot", "old_tasks", "new_id", "phase", "deadline")

    def __init__(self, slot, old_tasks, new_id, phase, deadline):
        self.slot = slot
        self.old_tasks = old_tasks
        self.new_id = new_id
        self.phase = phase          # 'wait_run' | 'wait_stop'
        self.deadline = deadline


class _ServiceUpdate:
    """Per-service rolling-update state machine inside the shared
    planner: one scalar `Updater._run` unrolled into non-blocking steps.
    Store writes go through the SHARED slot-flip helpers in
    updater.py."""

    def __init__(self, service_id: str):
        self.service_id = service_id
        self.phase = "init"          # init -> rolling -> drain -> (done)
        self.cfg = None
        self.rolling_back = False
        self.monitored: dict[str, float] = {}   # new task id -> deadline
        self.failed: set[str] = set()
        self.updated = 0
        self.in_flight: dict[int, _SlotFlip] = {}
        self.pending: list = []                 # queued dirty slot lists
        self.queued_slots: set[int] = set()
        self.cooldowns: list[float] = []        # worker busy-until stamps
        self.retry_at = 0.0                     # store-error backoff
        self.aborted = False
        self.done = False

    # ---- scalar-formula verdicts
    def over_threshold(self) -> bool:
        total = max(self.updated, 1)
        return (self.cfg.max_failure_ratio >= 0 and bool(self.failed)
                and len(self.failed) / total > self.cfg.max_failure_ratio)

    def poll_failures(self, store, now: float) -> None:
        if not self.monitored:
            return
        view = store.view()
        for tid in list(self.monitored):
            t = view.get_task(tid)
            if t is not None and t.status.state in (
                    TaskState.FAILED, TaskState.REJECTED):
                self.failed.add(tid)
                del self.monitored[tid]
            elif now > self.monitored[tid]:
                del self.monitored[tid]    # window expired healthy


class UpdateWavePlanner:
    """ONE thread drives every service's rolling update: the
    thread-per-service Updater does not survive a 100k-service mass
    update. Clock-injectable (FakeClock pins monitor-window and delay
    edges deterministically); per-service outcomes are pinned equal to
    the threaded Updater's by tests/test_torch_batched_orch.py."""

    POLL = 0.05

    def __init__(self, store, restart, clock=None):
        self.store = store
        self.restart = restart
        self._clock = clock or REAL_CLOCK
        self._lock = make_lock("orchestrator.updater.planner")
        self._states: dict[str, _ServiceUpdate] = {}
        self._wake = threading.Event()
        self._stop_ev = threading.Event()
        self._thread: threading.Thread | None = None
        self.stats: Counter = Counter()

    # ---------------------------------------------------------------- api
    def update(self, service, dirty_slots) -> None:
        """Supervisor entry: start (or keep) this service's update pass.
        A live pass supersedes in place — it re-reads the service every
        step, so a newer spec redirects the remaining waves (the scalar
        Supervisor.update alive-gate semantics)."""
        with self._lock:
            if self._stop_ev.is_set():
                return
            st = self._states.get(service.id)
            if st is not None and not st.done:
                return
            self._states[service.id] = _ServiceUpdate(service.id)
            self.stats["updates_started"] += 1
            stats["planner_updates"] += 1
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="update-wave-planner")
                self._thread.start()
        self._wake.set()

    def active(self) -> list[str]:
        with self._lock:
            return [sid for sid, st in self._states.items() if not st.done]

    def stop(self) -> None:
        """Cancel semantics: in-flight passes stop without a terminal
        status write (the scalar cancel path)."""
        self._stop_ev.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)

    # --------------------------------------------------------------- loop
    def _run(self):
        while not self._stop_ev.is_set():
            with self._lock:
                done = [sid for sid, st in self._states.items() if st.done]
                for sid in done:
                    del self._states[sid]
                states = list(self._states.values())
            if not states:
                # idle: real-time wait for the next update() regardless
                # of the injected clock (nothing is pacing)
                self._wake.wait(0.2)
                self._wake.clear()
                continue
            for st in states:
                if self._stop_ev.is_set():
                    return
                try:
                    self._step(st)
                except Exception:
                    # store hiccup mid-step: the pass stays live and
                    # retries after the scalar error backoff (1s)
                    log.exception("wave planner: step failed for %s",
                                  st.service_id[:8])
                    st.retry_at = self._clock.monotonic() + 1.0
            self._clock.wait(self._stop_ev, self.POLL)

    # -------------------------------------------------------------- steps
    def _step(self, st: _ServiceUpdate) -> None:
        now = self._clock.monotonic()
        if now < st.retry_at:
            return
        if st.phase == "init":
            self._step_init(st)
            if st.done or st.phase != "rolling":
                return
            now = self._clock.monotonic()
        if st.phase == "rolling":
            self._step_rolling(st, now)
        elif st.phase == "drain":
            self._step_drain(st, now)

    def _step_init(self, st: _ServiceUpdate) -> None:
        from .updater import set_update_status

        service = self.store.view().get_service(st.service_id)
        if service is None:
            st.done = True
            return
        state = (service.update_status or {}).get("state")
        if state in (UpdateStatusState.PAUSED.value,
                     UpdateStatusState.ROLLBACK_PAUSED.value):
            # paused stays paused until the operator acts (updater.go
            # Run:129-134)
            st.done = True
            return
        st.rolling_back = \
            state == UpdateStatusState.ROLLBACK_STARTED.value
        if st.rolling_back:
            from ..api.defaults import default_update_config

            st.cfg = service.spec.rollback or default_update_config()
        else:
            st.cfg = service.spec.update
            set_update_status(self.store, st.service_id,
                              UpdateStatusState.UPDATING,
                              "update in progress")
        st.phase = "rolling"

    def _step_rolling(self, st: _ServiceUpdate, now: float) -> None:
        from .updater import dirty_slots

        st.poll_failures(self.store, now)
        if st.over_threshold() and \
                st.cfg.failure_action != UpdateFailureAction.CONTINUE:
            st.aborted = True
            self._abort_in_flight(st, now)
            self._finalize(st)
            return
        service = self.store.view().get_service(st.service_id)
        if service is None:
            # flips are moot; unwind like the scalar abort-and-drain,
            # with no terminal status write
            st.aborted = True
            self._abort_in_flight(st, now)
            st.done = True
            return
        # advance in-flight flips BEFORE the dirty scan so an errored /
        # finished slot is re-discoverable in the same step
        for slot in list(st.in_flight):
            flip = st.in_flight.get(slot)
            if flip is not None:
                self._advance_slot(st, flip, now)
        fresh = [ts for ts in dirty_slots(self.store, service)
                 if ts[0].slot not in st.queued_slots]
        for ts in fresh:
            st.queued_slots.add(ts[0].slot)
            st.pending.append(ts)
        st.cooldowns = [c for c in st.cooldowns if c > now]
        backlog = len(st.pending) + len(st.in_flight)
        limit = st.cfg.parallelism or (backlog + len(st.cooldowns))
        while st.pending and \
                (len(st.in_flight) + len(st.cooldowns)) < limit:
            ts = st.pending.pop(0)
            try:
                self._start_flip(st, ts, now)
            except Exception:
                st.pending.insert(0, ts)
                raise
        if not st.in_flight and not st.pending and not fresh:
            st.phase = "drain"

    def _step_drain(self, st: _ServiceUpdate, now: float) -> None:
        st.poll_failures(self.store, now)
        if st.monitored and not st.over_threshold():
            return    # monitor tail still open
        self._finalize(st)

    # --------------------------------------------------------- slot flips
    def _start_flip(self, st: _ServiceUpdate, slot_tasks, now: float):
        from .updater import Updater, create_replacement

        slot = slot_tasks[0].slot
        if st.cfg.order == UpdateOrder.START_FIRST:
            new_id = create_replacement(self.store, st.service_id, slot,
                                        TaskState.RUNNING)
            if new_id is None:
                # service vanished mid-create: the rolling step's
                # service-gone gate ends the pass next step
                st.queued_slots.discard(slot)
                return
            st.in_flight[slot] = _SlotFlip(
                slot, slot_tasks, new_id, "wait_run",
                now + Updater.START_FIRST_TIMEOUT)
        else:
            new_id = create_replacement(self.store, st.service_id, slot,
                                        TaskState.READY,
                                        shutdown=slot_tasks)
            if new_id is None:
                st.queued_slots.discard(slot)
                return
            st.in_flight[slot] = _SlotFlip(
                slot, slot_tasks, new_id, "wait_stop",
                now + Updater.SLOT_PHASE_TIMEOUT)
        self.stats["flips_started"] += 1

    def _advance_slot(self, st: _ServiceUpdate, flip: _SlotFlip,
                      now: float) -> None:
        from .updater import promote_task, remove_task, shutdown_tasks

        view = self.store.view()
        if flip.phase == "wait_run":
            t = view.get_task(flip.new_id)
            if t is None or t.status.state >= TaskState.FAILED:
                # died before RUNNING: flows through the monitor window
                # like any young-task death
                self._finish_slot(st, flip, "ok", now)
            elif t.status.state >= TaskState.RUNNING:
                shutdown_tasks(self.store, flip.old_tasks)
                self._finish_slot(st, flip, "ok", now)
            elif now > flip.deadline:
                # wedged replacement: remove it, keep the old task, and
                # count the failure so the policy can act
                remove_task(self.store, flip.new_id)
                self._finish_slot(st, flip, "failed", now)
        else:   # wait_stop
            live = [tid for tid in (t.id for t in flip.old_tasks)
                    if (cur := view.get_task(tid)) is not None
                    and cur.status.state <= TaskState.RUNNING]
            if not live or now > flip.deadline:
                promote_task(self.store, flip.new_id)
                self._finish_slot(st, flip, "ok", now)

    def _finish_slot(self, st: _ServiceUpdate, flip: _SlotFlip,
                     outcome: str, now: float) -> None:
        st.in_flight.pop(flip.slot, None)
        st.queued_slots.discard(flip.slot)
        if outcome == "ok":
            st.updated += 1
            if st.cfg.monitor > 0:
                st.monitored[flip.new_id] = now + st.cfg.monitor
        elif outcome == "failed":
            st.updated += 1
            st.failed.add(flip.new_id or f"slot-{flip.slot}")
        if st.cfg.delay > 0:
            st.cooldowns.append(now + st.cfg.delay)

    def _abort_in_flight(self, st: _ServiceUpdate, now: float) -> None:
        """Policy abort: start-first waiters must not leave an unstarted
        replacement in the slot (removed, uncounted); stop-first waiters
        complete their promote and count (the scalar worker processes a
        returned outcome even after _abort)."""
        from .updater import promote_task, remove_task

        for flip in list(st.in_flight.values()):
            if flip.phase == "wait_run":
                try:
                    remove_task(self.store, flip.new_id)
                except Exception:
                    log.exception("wave planner: abort cleanup failed")
                st.in_flight.pop(flip.slot, None)
                st.queued_slots.discard(flip.slot)
            else:
                try:
                    promote_task(self.store, flip.new_id)
                except Exception:
                    log.exception("wave planner: abort promote failed")
                self._finish_slot(st, flip, "ok", now)
        for ts in st.pending:
            st.queued_slots.discard(ts[0].slot)
        st.pending.clear()

    def _finalize(self, st: _ServiceUpdate) -> None:
        from .updater import finalize_update

        total = max(st.updated, 1)
        finalize_update(self.store, st.service_id, st.cfg,
                        st.rolling_back,
                        st.over_threshold() or st.aborted,
                        len(st.failed), total)
        self.stats["updates_finished"] += 1
        st.done = True
