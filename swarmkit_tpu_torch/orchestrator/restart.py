"""Restart supervisor.

Behavioral re-derivation of manager/orchestrator/restart/restart.go: decides
whether a dead task restarts (condition any/on-failure/none), enforces
MaxAttempts within Window via per-slot history, marks the old task
desired=SHUTDOWN, creates the replacement in the same slot with
desired=READY, and promotes it to RUNNING after the configured delay
(DelayStart, restart.go:433-524).

The port's copy of the JAX package's `orchestrator/restart.py`.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

from ..analysis.lockgraph import make_lock
from ..api.objects import Service, Task
from ..api.types import RestartCondition, TaskState
from ..store.memory import MemoryStore
from .task import mark_shutdown, is_job, new_task


@dataclass
class RestartedInstance:
    timestamp: float


@dataclass
class InstanceRestartInfo:
    total_restarts: int = 0
    restarted_instances: list[RestartedInstance] = field(default_factory=list)


class RestartSupervisor:
    def __init__(self, store: MemoryStore, clock=None):
        from ..utils.clock import REAL_CLOCK

        self.store = store
        self._history: dict[tuple[str, int | str], InstanceRestartInfo] = {}
        self._delays: dict[str, threading.Timer] = {}
        self._lock = make_lock('orchestrator.restart.lock')
        self._stopped = False
        # injectable time source: the batched restart gate
        # (orchestrator/batched.py) and FakeClock window-edge pins read
        # the same clock the scalar gate does
        self._clock = clock or REAL_CLOCK

    def stop(self):
        with self._lock:
            self._stopped = True
            timers = list(self._delays.values())
            self._delays.clear()
        for t in timers:
            t.cancel()

    # ------------------------------------------------------------------ api
    def restart(self, tx, cluster, service: Service, task: Task) -> None:
        """Called within a store transaction when a task died
        (reference restart.go:117-213)."""
        # mark old task for shutdown if not already
        cur = tx.get_task(task.id)
        if cur is not None and cur.desired_state < TaskState.SHUTDOWN:
            cur = cur.copy()
            mark_shutdown(cur)
            tx.update(cur)

        if not self.should_restart(task, service):
            return

        self._spawn_replacement(tx, cluster, service, task)

    def restart_many(self, tx, cluster, pairs) -> None:
        """Batch form of `restart` for many dead tasks in ONE
        transaction (node-down rescheduling): the gate runs VECTORIZED
        (orchestrator/batched.py batch_should_restart, bit-identical to
        sequential scalar calls including interleaved history records),
        then each granted task spawns its replacement exactly like the
        scalar path."""
        from .batched import batch_should_restart

        grants = batch_should_restart(self, pairs)
        for (service, task), granted in zip(pairs, grants):
            cur = tx.get_task(task.id)
            if cur is not None and cur.desired_state < TaskState.SHUTDOWN:
                cur = cur.copy()
                mark_shutdown(cur)
                tx.update(cur)
            if granted:
                self._spawn_replacement(tx, cluster, service, task)

    def _spawn_replacement(self, tx, cluster, service: Service,
                           task: Task) -> None:
        replacement = new_task(cluster, service, task.slot,
                               task.node_id if not task.slot else "")
        replacement.desired_state = TaskState.READY
        tx.create(replacement)

        self._record(task, service)
        delay = service.spec.task.restart.delay
        # job tasks run to completion; service tasks run indefinitely
        target = TaskState.COMPLETE if is_job(service) else TaskState.RUNNING
        self._delay_start(replacement.id, delay, target)

    def should_restart(self, task: Task, service: Service) -> bool:
        """reference restart.go:215+ shouldRestart."""
        if is_job(service) and task.status.state == TaskState.COMPLETE:
            return False
        condition = service.spec.task.restart.condition
        if condition == RestartCondition.NONE:
            return False
        if condition == RestartCondition.ON_FAILURE and task.status.state in (
                TaskState.COMPLETE,):
            return False
        restart_policy = service.spec.task.restart
        if restart_policy.max_attempts > 0:
            key = self._instance_key(task)
            info = self._history.get(key)
            if info is not None:
                if restart_policy.window <= 0:
                    if info.total_restarts >= restart_policy.max_attempts:
                        return False
                else:
                    now = self._clock.time()
                    recent = [
                        r for r in info.restarted_instances
                        if now - r.timestamp <= restart_policy.window
                    ]
                    info.restarted_instances = recent
                    if len(recent) >= restart_policy.max_attempts:
                        return False
        return True

    # ------------------------------------------------------------ internals
    def _instance_key(self, task: Task):
        return (task.service_id, task.slot if task.slot else task.node_id)

    def _record(self, task: Task, service: Service) -> None:
        key = self._instance_key(task)
        info = self._history.setdefault(key, InstanceRestartInfo())
        info.total_restarts += 1
        if service.spec.task.restart.window > 0:
            info.restarted_instances.append(
                RestartedInstance(self._clock.time()))

    def resume_delay(self, task: Task, service: Service) -> None:
        """Re-arm the READY→RUNNING promote timer for a task found in
        delayed-start limbo at startup (the timer is in-memory state that
        dies with its leader; taskinit re-creates it on the successor)."""
        delay = service.spec.task.restart.delay if service is not None else 0.0
        self._delay_start(task.id, delay)

    def _delay_start(self, task_id: str, delay: float,
                     target: TaskState = TaskState.RUNNING) -> None:
        """Promote READY→target after the restart delay."""

        def promote():
            with self._lock:
                self._delays.pop(task_id, None)
                if self._stopped:
                    return

            def cb(tx):
                cur = tx.get_task(task_id)
                if cur is None or cur.desired_state != TaskState.READY:
                    return
                cur = cur.copy()
                cur.desired_state = target
                tx.update(cur)

            try:
                self.store.update(cb)
            except Exception:
                pass

        with self._lock:
            if self._stopped:
                return
            # served by the injected clock's timer service (the shared
            # TimerWheel under the real clock — no thread per armed
            # delay; FakeClock in tests fires on advance()). A zero
            # delay still goes through the wheel: we are called inside
            # the transaction that created the task, so the promote
            # must run on a fresh one
            self._delays[task_id] = self._clock.timer(max(delay, 0.0),
                                                      promote)

    def cancel_delay(self, task_id: str) -> None:
        with self._lock:
            t = self._delays.pop(task_id, None)
        if t:
            t.cancel()
