"""Allocator: advances tasks NEW → PENDING once resources are allocated.

Behavioral re-derivation of manager/allocator/: the in-tree reference ships
an *inert* network provider (networkallocator/inert.go — the real CNM
allocator lives in moby) plus a real port allocator; likewise here the
network backend is a pluggable seam defaulting to an inert provider, while
the address plane is real (allocator/ipam.py): networks get subnets and
gateways (doNetworkInit), services get per-network virtual IPs
(network.go allocateVIP), tasks get attachment addresses (doTaskAlloc,
network.go:870), nodes get ingress attachments (allocateNodes,
network.go:448), and published ports resolve through the dynamic range
30000-32767 (portallocator.go). All allocation state is rebuilt
idempotently from the replicated store on leadership change.

The port's copy of the JAX package's `allocator/allocator.py`. The
allocator always takes the array pools of `batched.py`, whose grants of
more than 4,096 addresses run on the card (kernel K19, `ops/alloc.py`);
the scalar `IPAM` and `PortAllocator` stay as their base classes and as
the oracle.
"""
from __future__ import annotations

import logging

from ..analysis.lockgraph import make_lock
from ..api.objects import (
    EventCreate,
    EventDelete,
    EventUpdate,
    Network,
    Node,
    Service,
    Task,
)
from ..api.types import NodeStatusState, TaskState
from ..store import by
from ..store.memory import MAX_CHANGES_PER_TRANSACTION
from ..orchestrator.base import EventLoopComponent
from ..utils import failpoints, lifecycle
from .ipam import IPAM, IPAMError

log = logging.getLogger("swarmkit_tpu_torch.allocator")

DYNAMIC_PORT_START = 30000  # reference portallocator.go dynamic range
DYNAMIC_PORT_END = 32767


class InertNetworkProvider:
    """No-op network backend (reference networkallocator/inert.go:12-40)."""

    def allocate_network(self, network) -> dict:
        return {}

    def allocate_service(self, service) -> dict:
        return {}

    def allocate_task(self, task) -> list:
        return []

    def deallocate(self, obj) -> None:
        pass


class PortAllocator:
    """Published-port bookkeeping (reference manager/allocator/portallocator.go).

    The oracle of `batched.BatchedPorts`, which repeats its owner
    precheck, dynamic runs and partial-failure shape grant for grant."""

    def __init__(self):
        self._allocated: dict[tuple[str, int], str] = {}  # (proto, port) -> service
        self._next_dynamic = DYNAMIC_PORT_START
        self._lock = make_lock('allocator.allocator.lock')

    def allocate(self, service_id: str, ports) -> bool:
        """Resolve published_port==0 to a dynamic port; refuse conflicts."""
        with self._lock:
            for p in ports:
                if p.published_port:
                    owner = self._allocated.get((p.protocol, p.published_port))
                    if owner is not None and owner != service_id:
                        return False
            for p in ports:
                if p.published_port:
                    self._allocated[(p.protocol, p.published_port)] = service_id
                elif p.publish_mode == "ingress":
                    port = self._find_dynamic(p.protocol)
                    if port is None:
                        return False
                    p.published_port = port
                    self._allocated[(p.protocol, port)] = service_id
            return True

    def _find_dynamic(self, protocol: str):
        start = self._next_dynamic
        port = start
        while True:
            if (protocol, port) not in self._allocated:
                self._next_dynamic = port + 1
                if self._next_dynamic > DYNAMIC_PORT_END:
                    self._next_dynamic = DYNAMIC_PORT_START
                return port
            port += 1
            if port > DYNAMIC_PORT_END:
                port = DYNAMIC_PORT_START
            if port == start:
                return None

    def release(self, service_id: str):
        with self._lock:
            for key in [k for k, v in self._allocated.items() if v == service_id]:
                del self._allocated[key]

    def release_except(self, service_id: str, keep: set[tuple[str, int]]) -> bool:
        """Release the service's ports not in `keep` (spec changed its port
        set). Returns True when anything was freed."""
        with self._lock:
            stale = [k for k, v in self._allocated.items()
                     if v == service_id and k not in keep]
            for k in stale:
                del self._allocated[k]
            return bool(stale)


class Allocator(EventLoopComponent):
    name = "allocator"

    def __init__(self, store, device=None):
        """The array pools (allocator/batched.py) move whole PENDING
        batches through per-network bulk grants, bit-identical to the
        scalar oracle. `device` is where a grant over more than
        POOL_THRESHOLD addresses runs: None, the current CUDA device
        (raising without one); "cpu", the plain PyTorch version."""
        super().__init__(store)
        self.network = InertNetworkProvider()
        from .batched import BatchedIPAM, BatchedPorts

        self.ports = BatchedPorts()
        self.ipam = BatchedIPAM(device=device)
        # services whose port allocation failed, retried when ports free up
        self._starved: set[str] = set()
        # tasks whose attachment addresses were already returned — terminal
        # tasks keep getting status updates, and a double release could free
        # an address the pool re-assigned in the meantime
        self._released_tasks: set[str] = set()
        # services whose VIP allocation hit an exhausted pool; retried when
        # any address is released (ports have the same mechanism above)
        self._vip_starved: set[str] = set()
        # services whose VIP/attachment wants were DEFERRED because a
        # referenced network isn't allocated yet:
        # an explicit marker set in the dispatcher reverse-index-as-hint
        # style — every hit is re-checked in-tx by _allocate_service, a
        # stale id heals lazily, and the find_services sweep remains the
        # un-primed fallback (primed by on_start's full pass)
        self._deferred_services: set[str] = set()
        self._deferred_primed = False

    def setup(self, tx):
        # ONE consistent snapshot: the NEW subset derives from the full task
        # list instead of a second, later view racing the first
        return (tx.find_tasks(), tx.find_services(), tx.find_networks(),
                tx.find_nodes())

    def on_start(self, snapshot):
        all_tasks, services, networks, nodes = snapshot
        tasks = [t for t in all_tasks if t.status.state == TaskState.NEW]
        # ---- idempotent state rebuild (doNetworkInit restore path) -------
        for n in networks:
            state = n.driver_state or {}
            if isinstance(state, dict) and state.get("subnet"):
                try:
                    self.ipam.add_network(n.id, state["subnet"])
                except (IPAMError, ValueError):
                    # a bad persisted subnet (a /32 accepted before the size
                    # check existed, or corrupted state) must not abort the
                    # whole rebuild — every later pool/VIP/attachment
                    # reservation would be skipped and a fresh leader would
                    # double-assign
                    log.warning("skipping unusable persisted subnet %s for "
                                "network %s", state["subnet"], n.id)
        def reserve(net_id, addr):
            # same tolerance as the pool loop above: one corrupted persisted
            # address (outside its subnet, or garbage) must not abort the
            # remaining reservations
            try:
                self.ipam.reserve(net_id, addr)
            except (IPAMError, ValueError):
                log.warning("skipping unusable persisted address %s on "
                            "network %s", addr, net_id)

        for s in services:
            if s.endpoint:
                for net_id, addr in s.endpoint.get("virtual_ips", []):
                    reserve(net_id, addr)
        for t in all_tasks:
            for att in t.networks or []:
                if isinstance(att, dict) and att.get("network_id"):
                    for addr in att.get("addresses", []):
                        reserve(att["network_id"], addr)
        for node in nodes:
            for att in node.attachments or []:
                if isinstance(att, dict) and att.get("network_id"):
                    for addr in att.get("addresses", []):
                        reserve(att["network_id"], addr)

        for n in networks:
            self._allocate_network(n.id)
        for s in services:
            self._allocate_service(s.id)
        # the full sweep above marked every service with unresolved
        # network refs: the deferred set is primed from here on
        self._deferred_primed = True
        for node in nodes:
            self._allocate_node(node.id)
        self._allocate_tasks([t.id for t in tasks])

    def handle(self, event):
        obj = getattr(event, "obj", None)
        if isinstance(event, (EventCreate, EventUpdate)):
            if isinstance(obj, Task):
                if obj.status.state == TaskState.NEW:
                    self._allocate_tasks([obj.id])
                elif obj.status.state >= TaskState.COMPLETE:
                    # dead task: its attachment addresses return to the pool
                    # (network.go doTaskAlloc handles task death the same way)
                    self._release_task_attachments(obj)
            elif isinstance(obj, Service):
                self._allocate_service(obj.id)
            elif isinstance(obj, Network):
                self._allocate_network(obj.id)
                # services created BEFORE their referenced network deferred
                # their VIPs; a fresh network unblocks them (and their tasks)
                self._retry_all_services()
                self._retry_waiting_tasks()
            elif isinstance(obj, Node):
                self._allocate_node(obj.id)
        elif isinstance(event, EventDelete):
            if isinstance(obj, Service):
                self.ports.release(obj.id)
                if obj.endpoint:
                    for net_id, addr in obj.endpoint.get("virtual_ips", []):
                        self.ipam.release(net_id, addr)
                self._retry_after_free()
            elif isinstance(obj, Network):
                self.network.deallocate(obj)
                self.ipam.remove_network(obj.id)
            elif isinstance(obj, Task):
                self._release_task_attachments(obj, deleted=True)
                self._released_tasks.discard(obj.id)
            elif isinstance(obj, Node):
                freed = False
                for att in obj.attachments or []:
                    if isinstance(att, dict):
                        for addr in att.get("addresses", []):
                            self.ipam.release(att["network_id"], addr)
                            freed = True
                if freed:
                    self._retry_after_free()

    def _release_task_attachments(self, task: Task, deleted: bool = False):
        """Return a dead task's addresses AND persist the release by
        clearing task.networks in the store — otherwise a later leader would
        rebuild its pools with (or re-release) addresses long since
        recycled. The in-memory guard only dedups same-leader event bursts.
        """
        if task.id in self._released_tasks:
            return
        self._released_tasks.add(task.id)
        released = False
        if not deleted:
            def clear(tx):
                nonlocal released
                cur = tx.get_task(task.id)
                if cur is None or not cur.networks:
                    return
                for att in cur.networks:
                    if isinstance(att, dict):
                        for addr in att.get("addresses", []):
                            self.ipam.release(att["network_id"], addr)
                released = True
                cur = cur.copy()
                cur.networks = []
                tx.update(cur)

            try:
                self.store.update(clear)
            except Exception:
                self._released_tasks.discard(task.id)  # retried next event
                return
        else:
            for att in task.networks or []:
                if isinstance(att, dict):
                    for addr in att.get("addresses", []):
                        self.ipam.release(att["network_id"], addr)
                        released = True
        if released:
            self._retry_after_free()

    def _retry_starved(self):
        """A freed port may unblock a service whose allocation failed; its
        NEW tasks were waiting on the service endpoint."""
        starved, self._starved = self._starved, set()
        for service_id in starved:
            self._allocate_service(service_id)
        if starved:
            self._retry_waiting_tasks()

    def _retry_waiting_tasks(self):
        view = self.store.view()
        pending = [t.id for t in view.find_tasks(by.ByTaskState(TaskState.NEW))]
        if pending:
            self._allocate_tasks(pending)

    def _retry_vip_starved(self):
        starved, self._vip_starved = self._vip_starved, set()
        for service_id in starved:
            self._allocate_service(service_id)

    def _retry_after_free(self):
        """Any released address/port may unblock anything that failed to
        allocate: port-starved services, VIP-starved services, and NEW
        tasks stuck on an exhausted pool."""
        self._retry_starved()
        self._retry_vip_starved()
        self._retry_waiting_tasks()

    def _retry_all_services(self):
        """A new network may complete services whose VIP allocation was
        DEFERRED (created before the network). Deferred services carry
        an explicit marker (`_deferred_services`, written wherever
        `_service_networks` returns None), so a network commit retries
        O(deferred), not O(services) — each hit re-checked in-tx by the
        idempotent _allocate_service (a still-unresolved service
        re-marks itself; a deleted one heals out of the set). Before
        on_start's full sweep primes the set, fall back to the
        find_services scan."""
        if not self._deferred_primed:
            view = self.store.view()
            for s in view.find_services():
                self._allocate_service(s.id)
            return
        deferred, self._deferred_services = self._deferred_services, set()
        pending = list(deferred)
        try:
            while pending:
                self._allocate_service(pending[-1])
                pending.pop()          # only a completed retry leaves
        except BaseException:
            # a transient failure (store churn) must not lose the
            # un-retried remainder — the old full sweep self-healed on
            # the next network event, so must the marker set
            self._deferred_services.update(pending)
            raise

    # -------------------------------------------------------- net resolution
    def _resolve_network(self, tx, target: str):
        """A NetworkAttachmentConfig.target is an id or a name."""
        n = tx.get_network(target)
        if n is not None:
            return n
        for n in tx.find_networks():
            if n.spec.annotations.name == target:
                return n
        return None

    def _service_networks(self, tx, service) -> list | None:
        """The networks a service's tasks attach to: explicit refs plus the
        ingress network when it publishes ingress-mode ports
        (network.go:448-1132). None == a referenced network is missing or
        not yet allocated (callers defer)."""
        nets = []
        for ref in service.spec.task.networks:
            n = self._resolve_network(tx, ref.target)
            if n is None or not self.ipam.has_network(n.id):
                return None
            nets.append(n)
        ports = service.spec.endpoint.ports
        if any(p.publish_mode == "ingress" for p in ports):
            for n in tx.find_networks():
                if n.spec.ingress:
                    if not self.ipam.has_network(n.id):
                        return None
                    if n.id not in [x.id for x in nets]:
                        nets.append(n)
                    break
        return nets

    # ------------------------------------------------------------- allocation
    def _allocate_network(self, network_id: str):
        def cb(tx):
            n = tx.get_network(network_id)
            if n is None:
                return
            state = n.driver_state if isinstance(n.driver_state, dict) else None
            if state is not None and state.get("subnet"):
                try:
                    self.ipam.add_network(n.id, state["subnet"])  # idempotent
                except (IPAMError, ValueError) as exc:
                    log.warning("network %s: unusable persisted subnet %s: "
                                "%s", network_id, state["subnet"], exc)
                return
            n = n.copy()
            wanted = (n.spec.ipam or {}).get("subnet") if n.spec.ipam else None
            try:
                subnet, gateway = self.ipam.add_network(n.id, wanted)
            except (IPAMError, ValueError) as exc:
                log.warning("network %s: subnet allocation failed: %s",
                            network_id, exc)
                return
            state = self.network.allocate_network(n) or {}
            state.update({"subnet": subnet, "gateway": gateway})
            n.driver_state = state
            tx.update(n)

        self.store.update(cb)

    def _allocate_node(self, node_id: str):
        """Ingress attachment for READY nodes (network.go allocateNodes —
        every node carrying ingress-published tasks needs an address on the
        ingress network)."""
        def cb(tx):
            node = tx.get_node(node_id)
            if node is None or node.status.state != NodeStatusState.READY:
                return
            ingress = next(
                (n for n in tx.find_networks() if n.spec.ingress), None)
            if ingress is None or not self.ipam.has_network(ingress.id):
                return
            existing = [a for a in (node.attachments or [])
                        if isinstance(a, dict)
                        and a.get("network_id") == ingress.id]
            if existing:
                return
            try:
                addr = self.ipam.allocate(ingress.id)
            except IPAMError:
                return
            node = node.copy()
            node.attachments = list(node.attachments or []) + [
                {"network_id": ingress.id, "addresses": [addr]}]
            tx.update(node)

        self.store.update(cb)

    def _allocate_service(self, service_id: str):
        freed = False

        def cb(tx):
            nonlocal freed
            s = tx.get_service(service_id)
            if s is None:
                return
            ports = s.spec.endpoint.ports
            nets = self._service_networks(tx, s)
            if nets is None:
                # referenced network not allocated yet: mark so the
                # network-commit retry is O(deferred) (_retry_all_services)
                self._deferred_services.add(s.id)
            endpoint = dict(s.endpoint or {})
            have_vips = {net_id: addr
                         for net_id, addr in endpoint.get("virtual_ips", [])}
            dirty = False

            # ---- virtual IPs: one per attached network (allocateVIP) -----
            # nets is None == a referenced network isn't allocated yet:
            # DEFER — releasing existing VIPs on that sentinel would hand
            # live addresses back to the pool mid-flight
            if nets is not None:
                if s.spec.endpoint.mode == "vip" and not s.pending_delete:
                    want_vips = [n.id for n in nets]
                    for net_id in want_vips:
                        if net_id not in have_vips:
                            try:
                                have_vips[net_id] = self.ipam.allocate(net_id)
                                dirty = True
                            except IPAMError:
                                self._vip_starved.add(s.id)
                else:
                    # dnsrr (or teardown): no VIPs are wanted — release any
                    # held ones, the reference deallocates on mode flips
                    want_vips = []
                for net_id in [k for k in have_vips if k not in want_vips]:
                    self.ipam.release(net_id, have_vips.pop(net_id))
                    dirty = True

            if not ports:
                # spec dropped all ports: free whatever was held and drop
                # the port fields so a later re-add re-claims from scratch
                freed = self.ports.release_except(service_id, set())
                if endpoint.get("ports_allocated") or dirty:
                    s = s.copy()
                    endpoint.pop("ports_allocated", None)
                    endpoint.pop("port_set", None)
                    endpoint.pop("ports", None)
                    endpoint["virtual_ips"] = sorted(have_vips.items())
                    s.endpoint = endpoint or None
                    tx.update(s)
                return
            if endpoint.get("ports_allocated"):
                # re-allocate only when the spec's port set changed
                current = {(p.protocol, p.target_port, p.published_port,
                            p.publish_mode) for p in ports}
                if endpoint.get("port_set") == sorted(current):
                    if dirty:
                        s = s.copy()
                        endpoint["virtual_ips"] = sorted(have_vips.items())
                        s.endpoint = endpoint
                        tx.update(s)
                    return
            s = s.copy()
            # free ports the new spec no longer publishes before claiming
            wanted = {(p.protocol, p.published_port)
                      for p in ports if p.published_port}
            freed = self.ports.release_except(s.id, wanted)
            ok = self.ports.allocate(s.id, s.spec.endpoint.ports)
            if not ok:
                self._starved.add(s.id)
                if dirty:
                    # VIP pool state already changed above — persist it even
                    # though ports are starved, or the endpoint would go on
                    # listing addresses the pool has re-handed out
                    endpoint["virtual_ips"] = sorted(have_vips.items())
                    s.endpoint = endpoint
                    tx.update(s)
                return  # retried when a conflicting service releases ports
            endpoint.update({
                "ports_allocated": True,
                "port_set": sorted({(p.protocol, p.target_port,
                                     p.published_port, p.publish_mode)
                                    for p in s.spec.endpoint.ports}),
                "ports": [
                    (p.protocol, p.target_port, p.published_port, p.publish_mode)
                    for p in s.spec.endpoint.ports
                ],
                "virtual_ips": sorted(have_vips.items()),
            })
            s.endpoint = endpoint
            tx.update(s)

        self.store.update(cb)
        if freed:
            self._retry_starved()

    def _allocate_tasks(self, task_ids: list[str]):
        # the scalar IPAM (the oracle, swapped in by the tests) has no
        # allocate_many and takes the per-task loop
        if len(task_ids) > 1 and hasattr(self.ipam, "allocate_many"):
            return self._allocate_tasks_batched(task_ids)
        # lifecycle plane: collect the ids actually moved NEW->PENDING
        # and file them as ONE batched record after the store batch (the
        # decision boundary); disarmed, no list is ever built
        moved: list[str] | None = [] if lifecycle.enabled() else None

        def cb(batch):
            for tid in task_ids:
                def move_one(tx, tid=tid):
                    t = tx.get_task(tid)
                    if t is None or t.status.state != TaskState.NEW:
                        return
                    service = tx.get_service(t.service_id) if t.service_id else None
                    if service is not None and service.spec.endpoint.ports and (
                            service.endpoint is None
                            or not service.endpoint.get("ports_allocated")):
                        return  # wait for service allocation first
                    # attachment addresses: explicit refs + ingress
                    attachments = []
                    if service is not None:
                        nets = self._service_networks(tx, service)
                        if nets is None:
                            self._deferred_services.add(service.id)
                            return  # a referenced network isn't ready yet
                        for n in nets:
                            try:
                                attachments.append({
                                    "network_id": n.id,
                                    "addresses": [self.ipam.allocate(n.id)],
                                })
                            except IPAMError:
                                for a in attachments:
                                    self.ipam.release(a["network_id"],
                                                      a["addresses"][0])
                                return  # pool exhausted: stays NEW
                    t = t.copy()
                    t.networks = (self.network.allocate_task(t) or []) \
                        + attachments
                    if service is not None and service.endpoint \
                            and service.endpoint.get("ports"):
                        from ..api.specs import EndpointSpec, PortConfig
                        t.endpoint = EndpointSpec(ports=[
                            PortConfig(protocol=proto, target_port=tp,
                                       published_port=pub, publish_mode=mode)
                            for proto, tp, pub, mode in service.endpoint["ports"]
                        ])
                    t.status.state = TaskState.PENDING
                    t.status.message = "pending task scheduling"
                    tx.update(t)
                    if moved is not None:
                        moved.append(tid)

                batch.update(move_one)

        self.store.batch(cb)
        if moved:
            lifecycle.record_batch(TaskState.PENDING, moved)

    # ------------------------------------------------ batched PENDING path
    def _allocate_tasks_batched(self, task_ids: list[str]):
        """The allocator's hot half over whole batches: per
        chunk, ONE in-tx validation pass plans the batch, per-network
        demand grants ride one `allocate_many` grant-order call
        each, and the tasks commit in one update transaction. When a
        pool can't cover its chunk demand the chunk falls back to the
        per-task probe loop — bit-identical to the scalar path,
        including its cursor churn on failed tasks. A chunk that crashes
        mid-flight (failpoint `alloc.batch.commit`, store errors)
        releases every uncommitted grant before re-raising, so a retry
        can't leak addresses."""
        moved: list[str] | None = [] if lifecycle.enabled() else None
        for off in range(0, len(task_ids), MAX_CHANGES_PER_TRANSACTION):
            chunk = task_ids[off:off + MAX_CHANGES_PER_TRANSACTION]
            granted: list[tuple[str, str]] = []
            try:
                self.store.update(
                    lambda tx, chunk=chunk: self._alloc_chunk_in_tx(
                        tx, chunk, granted, moved))
            except BaseException:
                # the transaction never committed: hand every grant of
                # this chunk back (release is an idempotent discard, so
                # per-task rollbacks already performed are harmless)
                for net_id, addr in granted:
                    self.ipam.release(net_id, addr)
                raise
        if moved:
            lifecycle.record_batch(TaskState.PENDING, moved)

    def _alloc_chunk_in_tx(self, tx, chunk, granted, moved):
        # pass 1: in-tx validation (same gates as the scalar move_one)
        # and per-network demand aggregation
        plans = []
        demand: dict[str, int] = {}
        for tid in chunk:
            t = tx.get_task(tid)
            if t is None or t.status.state != TaskState.NEW:
                continue
            service = tx.get_service(t.service_id) if t.service_id else None
            if service is not None and service.spec.endpoint.ports and (
                    service.endpoint is None
                    or not service.endpoint.get("ports_allocated")):
                continue  # wait for service allocation first
            nets = []
            if service is not None:
                nets = self._service_networks(tx, service)
                if nets is None:
                    self._deferred_services.add(service.id)
                    continue  # a referenced network isn't ready yet
                for n in nets:
                    demand[n.id] = demand.get(n.id, 0) + 1
            plans.append((t, service, nets))
        # pass 2: bulk grants when every pool covers its chunk demand —
        # K grants with no interleaved release == K sequential scalar
        # grants (ops/alloc.py), so the fallback below is the ONLY other
        # shape and both are oracle-identical
        bulk: dict[str, list[str]] | None = None
        if demand and all(self.ipam.free_count(nid) >= k
                          for nid, k in demand.items()):
            bulk = {}
            for nid, k in demand.items():
                addrs = self.ipam.allocate_many(nid, k)
                granted.extend((nid, a) for a in addrs)
                bulk[nid] = addrs[::-1]  # pop() consumes in grant order
        failpoints.fp("alloc.batch.commit")
        # pass 3: distribute in task order and stage the store writes
        for t, service, nets in plans:
            attachments = []
            if bulk is not None:
                for n in nets:
                    attachments.append({"network_id": n.id,
                                        "addresses": [bulk[n.id].pop()]})
            else:
                exhausted = False
                for n in nets:
                    try:
                        addr = self.ipam.allocate(n.id)
                    except IPAMError:
                        # pool exhausted: this task's partial grants go
                        # back, the task stays NEW (scalar semantics —
                        # the failed probes' cursor churn included)
                        for a in attachments:
                            self.ipam.release(a["network_id"],
                                              a["addresses"][0])
                        exhausted = True
                        break
                    granted.append((n.id, addr))
                    attachments.append({"network_id": n.id,
                                        "addresses": [addr]})
                if exhausted:
                    continue
            t = t.copy()
            t.networks = (self.network.allocate_task(t) or []) + attachments
            if service is not None and service.endpoint \
                    and service.endpoint.get("ports"):
                from ..api.specs import EndpointSpec, PortConfig
                t.endpoint = EndpointSpec(ports=[
                    PortConfig(protocol=proto, target_port=tp,
                               published_port=pub, publish_mode=mode)
                    for proto, tp, pub, mode in service.endpoint["ports"]
                ])
            t.status.state = TaskState.PENDING
            t.status.message = "pending task scheduling"
            tx.update(t)
            if moved is not None:
                moved.append(t.id)
