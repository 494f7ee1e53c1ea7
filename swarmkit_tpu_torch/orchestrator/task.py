"""Shared orchestrator task helpers.

Behavioral re-derivation of manager/orchestrator/{task.go, slot.go,
service.go}: the NewTask factory, spec-dirtiness check driving rolling
updates, slot grouping, and runnability predicates.

The port's copy of the JAX package's `orchestrator/task.py`.
"""
from __future__ import annotations

import time
from collections import defaultdict

from ..api.objects import Service, Task, Version
from ..api.specs import deepcopy_spec, spec_equal
from ..api.types import ServiceMode, TaskState
from ..utils import lifecycle
from ..utils.identity import new_id


def new_task(cluster, service: Service, slot: int, node_id: str = "") -> Task:
    """reference: manager/orchestrator/task.go NewTask."""
    t = Task(id=new_id())
    t.service_id = service.id
    t.slot = slot
    t.node_id = node_id
    t.spec = deepcopy_spec(service.spec.task)
    t.service_annotations = deepcopy_spec(service.spec.annotations)
    t.annotations = deepcopy_spec(service.spec.annotations)
    t.status.state = TaskState.NEW
    t.status.timestamp = time.time()
    t.status.message = "created"
    t.desired_state = (TaskState.COMPLETE if is_job(service)
                       else TaskState.RUNNING)
    t.spec_version = Version(service.spec_version.index)
    if is_job(service) and service.job_status is not None:
        t.job_iteration = Version(service.job_status.get("iteration", 0))
    # lifecycle plane: the NEW record, stamped with the same timestamp
    # the status carries (one truthiness test disarmed). The factory is
    # the one decision boundary every orchestrator's task creation
    # crosses; a creation whose enclosing tx aborts leaves a timeline
    # that simply never advances (observability, not bookkeeping).
    lifecycle.record(t.id, TaskState.NEW, t=t.status.timestamp)
    return t


def is_job(service: Service) -> bool:
    return service.spec.mode in (ServiceMode.REPLICATED_JOB, ServiceMode.GLOBAL_JOB)


def is_replicated(service: Service) -> bool:
    return service.spec.mode == ServiceMode.REPLICATED


def is_global(service: Service) -> bool:
    return service.spec.mode == ServiceMode.GLOBAL


def is_task_dirty(service: Service, task: Task) -> bool:
    """Spec drift that requires replacing the task
    (reference: manager/orchestrator/task.go IsTaskDirty)."""
    if task.spec_version is not None and service.spec_version is not None \
            and task.spec_version.index == service.spec_version.index:
        return False
    return not spec_equal(service.spec.task, task.spec)


def task_runnable(task: Task) -> bool:
    """Desired up and not observed dead."""
    return (task.desired_state <= TaskState.RUNNING
            and task.status.state <= TaskState.RUNNING)


def task_dead(task: Task) -> bool:
    return task.status.state > TaskState.RUNNING


def slots_by_service(tasks: list[Task]) -> dict[str, dict[int, list[Task]]]:
    """Service -> slot -> tasks (a slot may hold >1 task mid-update),
    mirroring the reference's Slot abstraction (slot.go)."""
    out: dict[str, dict[int, list[Task]]] = defaultdict(lambda: defaultdict(list))
    for t in tasks:
        out[t.service_id][t.slot].append(t)
    return out


def slot_runnable(slot_tasks: list[Task]) -> bool:
    return any(task_runnable(t) for t in slot_tasks)


def mark_shutdown(cur: Task) -> None:
    """Raise desired_state to SHUTDOWN on a (copied) task, finalizing the
    OBSERVED state too when no agent can: a task that was never dispatched
    to a node (status < ASSIGNED) has nothing running anywhere and nobody
    who would ever report it stopped — leaving its status PENDING wedges
    every 'wait until the old tasks stopped' loop for its full timeout
    (the reference's orchestrators write terminal status directly for
    unassigned tasks, updater.go removeOldTasks / restart.go)."""
    import time as _time

    cur.desired_state = TaskState.SHUTDOWN
    if cur.status.state < TaskState.ASSIGNED:
        cur.status.state = TaskState.SHUTDOWN
        cur.status.message = "shut down before assignment"
        cur.status.timestamp = _time.time()
        # the orchestrator is the status writer of record here (no agent
        # will ever report this task): close its timeline too
        lifecycle.record(cur.id, TaskState.SHUTDOWN,
                         t=cur.status.timestamp)
