"""Replicated-service orchestrator.

Behavioral re-derivation of manager/orchestrator/replicated/: reconciles each
replicated service's slot set against spec.replicas — scale-up creates NEW
tasks in free slots, scale-down prefers shutting slots on the most-loaded
nodes and non-running slots first (services.go:95-190) — and closes the
failure loop by routing dead tasks through the restart supervisor
(tasks.go:47-149). Node-down rescheduling (restartTasksByNodeID) also lives
here, shared with the global orchestrator via OrchestratorBase.

The port's copy of the JAX package's `orchestrator/replicated.py`. The
batched reconciler's slot census runs through `ops.reconcile
.compute_slot_state` on `device`: numpy below `DIFF_THRESHOLD` cells,
kernel K18 from it (None: the card, raising without one; "cpu": the plain
PyTorch version).
"""
from __future__ import annotations

import logging

from ..api.objects import (
    EventCreate,
    EventDelete,
    EventUpdate,
    Node,
    Service,
    Task,
)
from ..api.types import NodeAvailability, NodeStatusState, TaskState
from ..store import by
from .base import EventLoopComponent
from .batched import (
    BatchedReconciler,
    ReconcileDecision,
    fill_slots,
    victim_order,
)
from .restart import RestartSupervisor
from .task import (
    is_replicated,
    is_task_dirty,
    new_task,
    slot_runnable,
    slots_by_service,
)
from .updater import UpdateSupervisor

log = logging.getLogger("swarmkit_tpu_torch.orchestrator")

# bursts at or below this size skip the columnar pass (it scans the
# whole task table; an indexed per-service reconcile is cheaper until
# the burst amortizes the scan)
SMALL_RECONCILE_BATCH = 4


def decide_service(service, tasks) -> ReconcileDecision:
    """The scalar reconcile DECISION (replicated/services.go:95-190),
    separated from application: slot census over the live tasks
    (desired <= RUNNING), scale-up fills / scale-down victims via the
    shared primitives in orchestrator/batched.py, and the dirty-slot
    set for the rolling updater. The batched reconciler's vectorized
    pass is pinned decision-identical to this function (the ≥20-seed
    fuzz in tests/test_torch_batched_orch.py)."""
    d = ReconcileDecision()
    slots = slots_by_service(tasks).get(service.id, {})
    runnable = {
        slot: ts for slot, ts in slots.items() if slot_runnable(ts)
    }
    specified = service.spec.replicas
    if len(runnable) < specified:
        # scale up: fill the lowest free slot numbers
        d.create_slots = fill_slots(set(slots.keys()),
                                    specified - len(runnable))
    elif len(runnable) > specified:
        # scale down: keep running slots on least-loaded nodes,
        # iteratively recomputing load after each pick (victim_order)
        summaries = {
            slot: (any(t.status.state == TaskState.RUNNING for t in ts),
                   [t.node_id for t in ts if t.node_id])
            for slot, ts in runnable.items()
        }
        d.victim_slots = victim_order(summaries,
                                      len(runnable) - specified)
    # dirty slots (spec changed) → rolling updater; normalized slot /
    # task-id order so both deciders emit the identical structure
    d.dirty_slots = [
        sorted(runnable[slot], key=lambda t: t.id)
        for slot in sorted(runnable)
        if any(is_task_dirty(service, t) for t in runnable[slot])
    ]
    # a non-terminal update status with no dirty slot left still needs
    # its pass kicked (the restart supervisor can converge the slots on
    # its own; only the update pass writes the terminal status)
    d.kick_update = not d.dirty_slots and (
        (service.update_status or {}).get("state")
        in ("updating", "rollback_started"))
    return d


class ReplicatedOrchestrator(EventLoopComponent):
    name = "replicated-orchestrator"

    def __init__(self, store, device=None):
        super().__init__(store)
        self.restart = RestartSupervisor(store)
        self.updater = UpdateSupervisor(store, self.restart)
        # batched orchestration plane: vectorized reconcile passes over
        # the columnar hot columns; the scalar per-service path stays the
        # oracle
        self.batched = BatchedReconciler(store, device=device)
        self._pending_reconcile: set[str] = set()

    def stop(self):
        self.updater.stop()
        self.restart.stop()
        super().stop()

    # ----------------------------------------------------------------- setup
    def setup(self, tx):
        return [s for s in tx.find_services() if is_replicated(s)]

    def on_start(self, services):
        # startup fix-up first (taskinit/init.go CheckTasks): a fresh leader
        # inherits tasks stranded mid-lifecycle — dead-but-unreplaced, in
        # flight on nodes that went down unwatched, or parked in restart
        # -delay limbo whose promote timer died with the old leader
        from .taskinit import check_tasks

        try:
            check_tasks(self.store, self.restart, is_replicated)
        except Exception:
            log.exception("%s: startup task fix-up failed", self.name)
        # one vectorized classification pass instead of S serial
        # find_tasks walks; only actionable services pay a tx
        self.reconcile_many([s.id for s in services])

    # ---------------------------------------------------------------- events
    def handle(self, event):
        if isinstance(event, (EventCreate, EventUpdate)) and isinstance(
                event.obj, Service):
            if event.obj.pending_delete:
                # wind the tasks down so the deallocator can finish the
                # removal (deallocator.go waits for the last task)
                self._delete_service_tasks(event.obj)
            elif is_replicated(event.obj):
                # coalesce the burst; flush_events applies ONE
                # vectorized pass over it
                self._pending_reconcile.add(event.obj.id)
        elif isinstance(event, EventDelete) and isinstance(event.obj, Service):
            self._delete_service_tasks(event.obj)
        elif isinstance(event, EventUpdate) and isinstance(event.obj, Task):
            self._handle_task_change(event.obj)
        elif isinstance(event, EventDelete) and isinstance(event.obj, Task):
            t = event.obj
            if t.service_id:
                self._pending_reconcile.add(t.service_id)
        elif isinstance(event, EventUpdate) and isinstance(event.obj, Node):
            self._handle_node_change(event.obj)

    def flush_events(self):
        if not self._pending_reconcile:
            return
        ids = sorted(self._pending_reconcile)
        self._pending_reconcile.clear()
        try:
            self.reconcile_many(ids)
        except Exception:
            # a crashed burst must not drop its reconciles (the
            # dispatcher's crashed-flush re-dirty contract): re-dirty
            # everything and let idle()/the next burst retry — the
            # per-service reconcile is idempotent
            self._pending_reconcile.update(ids)
            raise

    def idle(self):
        # retry a re-dirtied burst even when no further event arrives
        self.flush_events()

    # ------------------------------------------------------------- reconcile
    def reconcile(self, service_id: str):
        """reference: replicated/services.go:95-190 (scalar path: decide
        + apply in one transaction)."""
        self.store.update(
            lambda tx: self._reconcile_in_tx(tx, service_id))

    def _reconcile_in_tx(self, tx, service_id: str):
        service = tx.get_service(service_id)
        if service is None or not is_replicated(service) \
                or service.pending_delete:
            return
        tasks = [
            t for t in tx.find_tasks(by.ByServiceID(service_id))
            if t.desired_state <= TaskState.RUNNING
        ]
        decision = decide_service(service, tasks)
        slots = slots_by_service(tasks).get(service_id, {})
        for slot_num in decision.create_slots:
            tx.create(new_task(None, service, slot_num))
        for slot_num in decision.victim_slots:
            for t in slots.get(slot_num, ()):
                cur = tx.get_task(t.id)
                if cur is not None \
                        and cur.desired_state < TaskState.REMOVE:
                    cur = cur.copy()
                    cur.desired_state = TaskState.REMOVE
                    tx.update(cur)
        if decision.dirty_slots or decision.kick_update:
            self.updater.update(service, decision.dirty_slots)

    def reconcile_many(self, service_ids: list[str]):
        """Batched reconcile: classify every service in one
        columnar array pass; steady services cost zero transactions and
        zero object reads. Actionable services re-validate IN-TX with
        the scalar decision code (the bulk_reconcile shape — decisions
        from the snapshot select WHO pays a transaction, the tx decides
        WHAT it does), batched into one store.batch. Dirty-only
        services just feed the updater."""
        if not service_ids:
            return
        if len(service_ids) <= SMALL_RECONCILE_BATCH:
            # tiny bursts (a lone task-delete event) keep the indexed
            # per-service path: the columnar pass scans ALL task rows,
            # which only pays off when the burst amortizes it (the
            # compute_slot_state DIFF_THRESHOLD idea, one level up)
            for sid in service_ids:
                self.reconcile(sid)
            return
        view = self.store.view()
        decisions = self.batched.decide_many(service_ids, view=view)
        actionable = {sid for sid, d in decisions.items() if d.actionable}
        for sid, d in decisions.items():
            if (d.dirty_slots or d.kick_update) and sid not in actionable:
                service = view.get_service(sid)
                if service is not None:
                    self.updater.update(service, d.dirty_slots)

        if actionable:
            def apply(batch):
                for sid in sorted(actionable):
                    def one(tx, sid=sid):
                        self._reconcile_in_tx(tx, sid)
                    batch.update(one)

            self.store.batch(apply)

    # ----------------------------------------------------------- task events
    def _handle_task_change(self, task: Task):
        """Dead task whose slot is still desired → restart
        (reference replicated/tasks.go:47-149)."""
        if task.status.state <= TaskState.RUNNING:
            return
        if task.desired_state > TaskState.RUNNING:
            return  # shutdown was requested; reaper handles cleanup

        def cb(tx):
            service = tx.get_service(task.service_id)
            if service is None or not is_replicated(service) \
                    or service.pending_delete:
                return
            if task.slot > service.spec.replicas:
                return
            self.restart.restart(tx, None, service, task)

        self.store.update(cb)

    # ----------------------------------------------------------- node events
    def _handle_node_change(self, node: Node):
        down = (node.status.state == NodeStatusState.DOWN
                or node.spec.availability == NodeAvailability.DRAIN)
        if not down:
            return

        def cb(tx):
            pairs = []
            for task in tx.find_tasks(by.ByNodeID(node.id)):
                if task.desired_state > TaskState.RUNNING:
                    continue
                if task.status.state > TaskState.RUNNING:
                    continue
                service = tx.get_service(task.service_id)
                if service is None or not is_replicated(service):
                    continue
                pairs.append((service, task))
            if pairs:
                # one vectorized restart gate for the whole node's
                # victims (bit-identical to the sequential calls)
                self.restart.restart_many(tx, None, pairs)

        self.store.update(cb)

    def _delete_service_tasks(self, service: Service):
        def cb(batch):
            tasks = self.store.view().find_tasks(by.ByServiceID(service.id))
            for t in tasks:
                def delete_one(tx, t=t):
                    if tx.get_task(t.id) is not None:
                        tx.delete(Task, t.id)
                batch.update(delete_one)

        self.store.batch(cb)
