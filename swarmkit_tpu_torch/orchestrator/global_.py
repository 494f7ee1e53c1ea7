"""Global-service orchestrator.

Behavioral re-derivation of manager/orchestrator/global/global.go: one task
per eligible node per global service. Constraints are pre-filtered here
(constraint.NodeMatches before creating, global.go:254-487) so tasks are
created with node_id preset and the scheduler only *validates* fit. Drained,
paused or down nodes get their tasks shut down; new/recovered nodes get
tasks created.

The port's copy of the JAX package's `orchestrator/global_.py`. The
startup reconcile's set diff runs through `ops.reconcile.compute_diff` on
`device`: numpy below `DIFF_THRESHOLD` cells, kernel K14 at or above it
(None: the card, raising without one; "cpu": the plain PyTorch version).
"""
from __future__ import annotations

from ..api.objects import (
    EventCreate,
    EventDelete,
    EventUpdate,
    Node,
    Service,
    Task,
)
from ..api.types import NodeAvailability, NodeStatusState, TaskState
from ..scheduler import constraint as constraint_mod
from ..store import by
from .base import EventLoopComponent
from .restart import RestartSupervisor
from .task import mark_shutdown, is_global, new_task, task_runnable


def _constraints_met(node: Node, service: Service) -> bool:
    exprs = service.spec.task.placement.constraints
    if exprs:
        try:
            constraints = constraint_mod.parse(exprs)
        except constraint_mod.InvalidConstraint:
            return False
        if not constraint_mod.node_matches(constraints, node):
            return False
    return True


def _node_eligible(node: Node, service: Service) -> bool:
    """May a NEW global task be added (or a failed one restarted) here?
    Reference global.go:389-392: PAUSE means no add/update."""
    if node.status.state != NodeStatusState.READY:
        return False
    if node.spec.availability != NodeAvailability.ACTIVE:
        return False
    return _constraints_met(node, service)


def _node_keeps_tasks(node: Node, service: Service) -> bool:
    """May EXISTING global tasks keep running here? Distinct from
    eligibility: a PAUSED node keeps its tasks (no add/update only), and
    so does a transiently-UNKNOWN node (leadership change demotes every
    node to UNKNOWN until it re-registers — evicting would churn all
    global services on each election). Shutdown only on DOWN, DRAIN, or
    constraints no longer met (global.go:383-392 + invalid-node check)."""
    if node.status.state == NodeStatusState.DOWN:
        return False
    if node.spec.availability == NodeAvailability.DRAIN:
        return False
    return _constraints_met(node, service)


class GlobalOrchestrator(EventLoopComponent):
    name = "global-orchestrator"

    def __init__(self, store, device=None):
        super().__init__(store)
        self.restart = RestartSupervisor(store)
        self.device = device

    def stop(self):
        self.restart.stop()
        super().stop()

    def setup(self, tx):
        return [s for s in tx.find_services() if is_global(s)]

    def on_start(self, services):
        # taskinit/init.go CheckTasks — see ReplicatedOrchestrator.on_start
        from .taskinit import check_tasks

        try:
            check_tasks(self.store, self.restart, is_global)
        except Exception:
            pass
        # startup reconciliation of ALL global services in one batched
        # desired-vs-actual diff (ops/reconcile.py) instead of S separate
        # (service × node) walks; identical semantics to reconcile_service
        self.bulk_reconcile([s.id for s in services])

    def bulk_reconcile(self, service_ids: list[str]):
        """Reconcile many global services at once: host-side eligibility
        (string/constraint work), then one `ops.reconcile.compute_diff`
        set-diff for the whole S×N decision matrix, then one store batch
        applying creates/shutdowns."""
        if not service_ids:
            return
        import numpy as np

        from ..ops.reconcile import compute_diff

        plan: list[tuple[str, str, bool]] = []  # (service, node, create?)

        def scan(tx):
            nodes = sorted(tx.find_nodes(), key=lambda n: n.id)
            node_row = {n.id: i for i, n in enumerate(nodes)}
            svcs = []
            for sid in service_ids:
                s = tx.get_service(sid)
                if s is not None and is_global(s) and not s.pending_delete:
                    svcs.append(s)
            if not svcs or not nodes:
                return
            S, N = len(svcs), len(nodes)
            eligible = np.zeros((S, N), bool)   # gates ADDS
            keeps = np.zeros((S, N), bool)      # gates SHUTDOWNS (pause keeps)
            for si, s in enumerate(svcs):
                for ni, n in enumerate(nodes):
                    eligible[si, ni] = _node_eligible(n, s)
                    keeps[si, ni] = _node_keeps_tasks(n, s)
            # two 'actual' sets, as in reconcile_service: create is gated on
            # RUNNABLE tasks; shutdown covers any task with desired<=RUNNING
            runnable_rows: list[list[int]] = []
            active_rows: list[list[int]] = []
            for s in svcs:
                run, act = [], []
                for t in tx.find_tasks(by.ByServiceID(s.id)):
                    if t.desired_state > TaskState.RUNNING:
                        continue
                    ni = node_row.get(t.node_id)
                    if ni is None:
                        continue
                    act.append(ni)
                    if task_runnable(t):
                        run.append(ni)
                runnable_rows.append(run)
                active_rows.append(act)

            def pack(rows_list):
                T = max((len(r) for r in rows_list), default=0) or 1
                out = np.full((S, T), -1, np.int32)
                for si, rows in enumerate(rows_list):
                    out[si, :len(rows)] = rows
                return out

            create, _ = compute_diff(eligible, pack(runnable_rows),
                                     device=self.device)
            _, shutdown = compute_diff(keeps, pack(active_rows),
                                       device=self.device)
            for si, s in enumerate(svcs):
                for ni in np.flatnonzero(create[si]):
                    plan.append((s.id, nodes[ni].id, True))
                for ni in np.flatnonzero(shutdown[si]):
                    plan.append((s.id, nodes[ni].id, False))

        with_view = getattr(self.store, "view", None)
        tx = with_view()
        scan(tx)
        if not plan:
            return

        def apply(batch):
            for sid, nid, is_create in plan:
                def one(tx, sid=sid, nid=nid, is_create=is_create):
                    service = tx.get_service(sid)
                    if service is None or not is_global(service) \
                            or service.pending_delete:
                        return
                    if is_create:
                        node = tx.get_node(nid)
                        # re-validate inside the tx (state may have moved)
                        if node is None or not _node_eligible(node, service):
                            return
                        # the node's tasks, not the service's: the same
                        # set, without walking every task of the service
                        # on each create
                        exists = any(
                            t.desired_state <= TaskState.RUNNING
                            and task_runnable(t) and t.service_id == sid
                            for t in tx.find_tasks(by.ByNodeID(nid)))
                        if not exists:
                            tx.create(new_task(None, service, 0, node_id=nid))
                    else:
                        node = tx.get_node(nid)
                        if node is not None and \
                                _node_keeps_tasks(node, service):
                            return  # node recovered between scan and apply
                        for t in tx.find_tasks(by.ByNodeID(nid)):
                            if t.service_id != sid or \
                                    t.desired_state > TaskState.RUNNING:
                                continue
                            cur = tx.get_task(t.id)
                            if cur is not None and \
                                    cur.desired_state < TaskState.SHUTDOWN:
                                cur = cur.copy()
                                mark_shutdown(cur)
                                tx.update(cur)
                batch.update(one)

        self.store.batch(apply)

    def handle(self, event):
        obj = getattr(event, "obj", None)
        if isinstance(obj, Service):
            if isinstance(event, EventDelete) or obj.pending_delete:
                self._delete_service_tasks(obj)
            elif is_global(obj):
                self.reconcile_service(obj.id)
        elif isinstance(obj, Node):
            if isinstance(event, EventDelete):
                self._node_removed(obj)
            else:
                self.reconcile_node(obj.id)
        elif isinstance(obj, Task) and isinstance(event, EventUpdate):
            self._handle_task_change(obj)

    # ------------------------------------------------------------- reconcile
    def reconcile_service(self, service_id: str):
        def cb(tx):
            service = tx.get_service(service_id)
            if service is None or not is_global(service) \
                    or service.pending_delete:
                return
            nodes = tx.find_nodes()
            tasks = tx.find_tasks(by.ByServiceID(service_id))
            by_node: dict[str, list[Task]] = {}
            for t in tasks:
                if t.desired_state <= TaskState.RUNNING:
                    by_node.setdefault(t.node_id, []).append(t)
            for node in nodes:
                eligible = _node_eligible(node, service)
                existing = [t for t in by_node.get(node.id, [])
                            if task_runnable(t)]
                if eligible and not existing:
                    t = new_task(None, service, 0, node_id=node.id)
                    tx.create(t)
                elif not _node_keeps_tasks(node, service):
                    for t in by_node.get(node.id, []):
                        cur = tx.get_task(t.id)
                        if cur is not None and cur.desired_state < TaskState.SHUTDOWN:
                            cur = cur.copy()
                            mark_shutdown(cur)
                            tx.update(cur)

        self.store.update(cb)

    def reconcile_node(self, node_id: str):
        def cb(tx):
            node = tx.get_node(node_id)
            if node is None:
                return
            services = [s for s in tx.find_services()
                        if is_global(s) and not s.pending_delete]
            tasks = tx.find_tasks(by.ByNodeID(node_id))
            by_service: dict[str, list[Task]] = {}
            for t in tasks:
                if t.desired_state <= TaskState.RUNNING:
                    by_service.setdefault(t.service_id, []).append(t)
            for service in services:
                eligible = _node_eligible(node, service)
                existing = [t for t in by_service.get(service.id, [])
                            if task_runnable(t)]
                if eligible and not existing:
                    tx.create(new_task(None, service, 0, node_id=node_id))
                elif not _node_keeps_tasks(node, service):
                    for t in by_service.get(service.id, []):
                        cur = tx.get_task(t.id)
                        if cur is not None and cur.desired_state < TaskState.SHUTDOWN:
                            cur = cur.copy()
                            mark_shutdown(cur)
                            tx.update(cur)

        self.store.update(cb)

    def _node_removed(self, node: Node):
        def cb(tx):
            for t in tx.find_tasks(by.ByNodeID(node.id)):
                service = tx.get_service(t.service_id)
                if service is not None and is_global(service):
                    if tx.get_task(t.id) is not None:
                        tx.delete(Task, t.id)

        self.store.update(cb)

    def _handle_task_change(self, task: Task):
        if task.status.state <= TaskState.RUNNING:
            return
        if task.desired_state > TaskState.RUNNING:
            return

        def cb(tx):
            service = tx.get_service(task.service_id)
            if service is None or not is_global(service) \
                    or service.pending_delete:
                return
            node = tx.get_node(task.node_id) if task.node_id else None
            if node is None or not _node_eligible(node, service):
                return
            self.restart.restart(tx, None, service, task)

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
