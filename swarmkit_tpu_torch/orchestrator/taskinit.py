"""Startup task fix-up.

Behavioral re-derivation of manager/orchestrator/taskinit/init.go
CheckTasks: when an orchestrator (re)starts — e.g. after a leadership
change — tasks may be stranded mid-lifecycle: dead but never restarted, or
in flight on a node that went down while no leader was watching. This pass
runs once over a snapshot and routes each such task through the restart
supervisor so the normal reconcile loops take over from a clean state.

The port's copy of the JAX package's `orchestrator/taskinit.py`.
"""
from __future__ import annotations

from collections.abc import Callable

from ..api.objects import Service, Task
from ..api.types import NodeAvailability, NodeStatusState, TaskState
from ..store import by
from ..store.memory import MemoryStore
from .restart import RestartSupervisor


def check_tasks(store: MemoryStore, restart: RestartSupervisor,
                is_related: Callable[[Service], bool]) -> int:
    """Fix up stranded tasks for services matching `is_related`.
    Returns the number of tasks routed to restart."""
    fixed = 0

    def cb(tx):
        nonlocal fixed
        node_down = {}
        for n in tx.find_nodes():
            node_down[n.id] = (
                n.status.state == NodeStatusState.DOWN
                or n.spec.availability == NodeAvailability.DRAIN)
        for t in tx.find_tasks():
            if t.desired_state > TaskState.RUNNING:
                continue
            service = tx.get_service(t.service_id)
            if service is None or not is_related(service):
                continue
            dead = t.status.state > TaskState.RUNNING
            stranded = (
                t.node_id != ""
                and t.status.state >= TaskState.ASSIGNED
                and node_down.get(t.node_id, True))
            if dead or stranded:
                # node-down wins over delay-limbo: re-arming a promote
                # timer for a task on a dead node would strand it forever
                restart.restart(tx, None, service, t)
                fixed += 1
            elif t.desired_state == TaskState.READY \
                    and t.status.state <= TaskState.READY:
                # restart-delay limbo: the promote timer lived on the
                # previous leader and died with it — re-arm the delayed
                # start (taskinit/init.go:174 restartSupervisor.DelayStart)
                restart.resume_delay(t, service)
                fixed += 1

    store.update(cb)
    return fixed
