"""Deallocator: completes deferred deletion of user-facing resources.

Re-derivation of manager/deallocator/deallocator.go: services marked
`pending_delete` wait until their last task is gone, then the service
record is deleted and any of its service-level networks that are
themselves pending deletion (and now unused) are freed; networks marked
`pending_delete` independently are deleted once nothing references them.
The deallocator is the only place a pending-delete object is finally
removed — tasks are the task reaper's job, this handles what the USER
owns.

The port's copy of the JAX package's `allocator/deallocator.py`.
"""
from __future__ import annotations

from ..api.objects import (
    EventCreate,
    EventDelete,
    EventUpdate,
    Network,
    Service,
    Task,
)
from ..orchestrator.base import EventLoopComponent
from ..store import by


class Deallocator(EventLoopComponent):
    name = "deallocator"

    def setup(self, tx):
        return (tx.find_services(), tx.find_networks())

    def on_start(self, snapshot):
        services, networks = snapshot
        for s in services:
            if s.pending_delete:
                self._process_service(s.id)
        for n in networks:
            if n.pending_delete:
                self._process_network(n.id)

    def handle(self, event):
        obj = getattr(event, "obj", None)
        if isinstance(event, EventDelete) and isinstance(obj, Task):
            if obj.service_id:
                self._process_service(obj.service_id)
        elif isinstance(event, (EventCreate, EventUpdate)) \
                and isinstance(obj, Service):
            if obj.pending_delete:
                self._process_service(obj.id)
        elif isinstance(event, (EventCreate, EventUpdate)) \
                and isinstance(obj, Network):
            if obj.pending_delete:
                self._process_network(obj.id)
        elif isinstance(event, EventDelete) and isinstance(obj, Service):
            # a freed service may unblock pending-delete networks
            for na in list(obj.spec.task.networks) + list(obj.spec.networks):
                if na.target:
                    self._process_network(na.target)

    # ------------------------------------------------------------- services
    def _process_service(self, service_id: str):
        nets: list[str] = []

        def cb(tx):
            s = tx.get_service(service_id)
            if s is None or not s.pending_delete:
                return
            if tx.find_tasks(by.ByServiceID(service_id)):
                return  # tasks still winding down
            for na in list(s.spec.task.networks) + list(s.spec.networks):
                if na.target:
                    nets.append(na.target)
            tx.delete(Service, service_id)

        self.store.update(cb)
        for nid in nets:
            self._process_network(nid)

    # ------------------------------------------------------------- networks
    def _process_network(self, network_id: str):
        def cb(tx):
            n = tx.get_network(network_id)
            if n is None or not n.pending_delete:
                return
            for s in tx.find_services():
                targets = {na.target for na in s.spec.task.networks}
                targets |= {na.target for na in s.spec.networks}
                if network_id in targets:
                    return  # still referenced
            for t in tx.find_tasks():
                if network_id in (t.networks or []):
                    return
            tx.delete(Network, network_id)

        self.store.update(cb)
