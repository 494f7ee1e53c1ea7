"""The port's allocator plane against the JAX package's.

Each scenario is built from the same seeded data in a JAX store and in a
port store; the JAX `Allocator` runs on the first, the port's
`Allocator(device="cpu")` (and, where the scenario says so, the port's
allocator with the scalar `IPAM` and `PortAllocator` swapped in) on the
second. The allocators run their startup pass (`view_and_watch(setup)`,
then `on_start`) and then handle the store's events one by one on the
test's thread, so both see the same events in the same order. Afterwards
every task's state, attachment addresses and ports, every service's
endpoint (VIPs and ports), every network's subnet and gateway and every
node's attachments must be equal: exact equality. The mirrored scenarios
are those of tests/test_network_allocation.py, tests/test_batched_alloc.py
and the two deallocator scenarios of tests/test_deallocator_drivers.py,
which the port drives directly (it has no `Manager`). One test runs both
allocators' event loops, each stopped in a `finally`.
"""
import time
from types import SimpleNamespace

import pytest
import torch

from swarmkit_tpu.allocator import allocator as jax_allocator
from swarmkit_tpu.allocator import deallocator as jax_deallocator
from swarmkit_tpu.api import objects as jax_objects
from swarmkit_tpu.api import specs as jax_specs
from swarmkit_tpu.api import types as jax_types
from swarmkit_tpu.store import memory as jax_memory
from swarmkit_tpu.utils import failpoints as jax_failpoints
from swarmkit_tpu_torch.allocator import allocator as torch_allocator
from swarmkit_tpu_torch.allocator import deallocator as torch_deallocator
from swarmkit_tpu_torch.allocator.ipam import IPAM
from swarmkit_tpu_torch.api import objects as torch_objects
from swarmkit_tpu_torch.api import specs as torch_specs
from swarmkit_tpu_torch.api import types as torch_types
from swarmkit_tpu_torch.store import memory as torch_memory
from swarmkit_tpu_torch.utils import failpoints as torch_failpoints

torch.set_num_threads(1)

JAX = SimpleNamespace(
    name="jax", o=jax_objects, s=jax_specs, t=jax_types, mem=jax_memory,
    fp=jax_failpoints, dealloc=jax_deallocator.Deallocator,
    alloc=lambda store: jax_allocator.Allocator(store, batched=True))
TORCH = SimpleNamespace(
    name="torch", o=torch_objects, s=torch_specs, t=torch_types,
    mem=torch_memory, fp=torch_failpoints,
    dealloc=torch_deallocator.Deallocator,
    alloc=lambda store: torch_allocator.Allocator(store, device="cpu"))


def scalar_alloc(store):
    """The port's allocator on the scalar oracles: no allocate_many, so
    every task takes the per-task loop."""
    a = torch_allocator.Allocator(store, device="cpu")
    a.ipam, a.ports = IPAM(), torch_allocator.PortAllocator()
    return a


SCALAR = SimpleNamespace(**{**vars(TORCH), "name": "scalar",
                            "alloc": scalar_alloc})


# ------------------------------------------------------------ scenario kit
def mk_network(P, store, net_id="net1", name="backend", ingress=False,
               subnet=None):
    n = P.o.Network(id=net_id, spec=P.s.NetworkSpec(
        annotations=P.s.Annotations(name=name), ingress=ingress,
        ipam={"subnet": subnet} if subnet else None))
    store.update(lambda tx: tx.create(n))


def mk_service(P, store, svc_id="svc1", networks=(), ports=(), replicas=1):
    s = P.o.Service(id=svc_id, spec=P.s.ServiceSpec(
        annotations=P.s.Annotations(name=svc_id), replicas=replicas))
    s.spec.task.networks = [P.s.NetworkAttachmentConfig(target=t)
                            for t in networks]
    s.spec.endpoint.ports = [P.s.PortConfig(**p) for p in ports]
    store.update(lambda tx: tx.create(s))


def mk_tasks(P, store, ids, svc_id="svc1"):
    def cb(tx):
        for i, tid in enumerate(ids):
            t = P.o.Task(id=tid, service_id=svc_id, slot=i + 1)
            t.status.state = P.t.TaskState.NEW
            t.desired_state = P.t.TaskState.RUNNING
            tx.create(t)
    store.update(cb)


def mk_node(P, store, node_id="node1"):
    n = P.o.Node(id=node_id)
    n.status.state = P.t.NodeStatusState.READY
    store.update(lambda tx: tx.create(n))


def set_task_state(P, store, tid, state):
    def cb(tx):
        t = tx.get_task(tid).copy()
        t.status.state = getattr(P.t.TaskState, state)
        tx.update(t)
    store.update(cb)


def flip_dnsrr(P, store, svc_id="svc1"):
    def cb(tx):
        s = tx.get_service(svc_id).copy()
        s.spec.endpoint.mode = "dnsrr"
        tx.update(s)
    store.update(cb)


def pump(ch, comp):
    """Hand every queued event to the component, its own writes' events
    too, until the queue is empty."""
    while True:
        ev = ch.try_get()
        if ev is None:
            return
        comp.handle(ev)


class Run:
    """One package's store and the component on it, started as a new
    leader starts it: view_and_watch(setup), then on_start."""

    def __init__(self, P, make=None):
        self.P = P
        self.store = P.mem.MemoryStore()
        self.make = make or P.alloc
        self.comp = self.ch = None

    def start(self):
        """Start a component; a component already running is dropped
        first, as a demoted leader's is."""
        if self.ch is not None:
            self.store.queue.stop_watch(self.ch)
            self.ch = None
        self.comp = self.make(self.store)
        snap, ch = self.store.view_and_watch(self.comp.setup, limit=None)
        try:
            self.comp.on_start(snap)
        except BaseException:
            self.store.queue.stop_watch(ch)
            raise
        self.ch = ch
        pump(self.ch, self.comp)
        return self

    def do(self, fn, *a, **kw):
        fn(self.P, self.store, *a, **kw)
        if self.ch is not None:
            pump(self.ch, self.comp)
        return self

    def image(self):
        return image(self.store)


def image(store):
    """Everything the allocator writes, as plain values."""
    v = store.view()
    tasks = {}
    for t in v.find_tasks():
        ports = tuple((p.protocol, p.target_port, p.published_port,
                       p.publish_mode) for p in t.endpoint.ports) \
            if t.endpoint else ()
        tasks[t.id] = (int(t.status.state), int(t.desired_state), ports,
                       tuple((a["network_id"], tuple(a["addresses"]))
                             for a in t.networks or []
                             if isinstance(a, dict)))
    services = {s.id: s.endpoint for s in v.find_services()}
    networks = {n.id: n.driver_state for n in v.find_networks()}
    nodes = {n.id: n.attachments for n in v.find_nodes()}
    return tasks, services, networks, nodes


def pools(comp):
    return {nid: (set(p.allocated), p._cursor)
            for nid, p in comp.ipam._pools.items()}


def assert_same(*runs):
    want = runs[0].image()
    for r in runs[1:]:
        assert r.image() == want, f"{r.P.name} differs from {runs[0].P.name}"
    if all(hasattr(r.comp, "ipam") for r in runs):
        want = pools(runs[0].comp)
        for r in runs[1:]:
            assert pools(r.comp) == want


def both(fn, packages=(JAX, TORCH)):
    runs = [Run(P) for P in packages]
    for r in runs:
        fn(r)
    assert_same(*runs)
    return runs


# ----------------------------------------------------------------- scenarios
def test_networks_vips_and_attachments():
    def scenario(r):
        r.do(mk_network, subnet="172.20.0.0/24")
        r.do(mk_network, net_id="net2", name="auto")
        r.do(mk_network, net_id="ingress", name="ingress", ingress=True)
        r.do(mk_node)
        r.do(mk_service, networks=["backend", "net2"])
        r.do(mk_service, svc_id="web", ports=[dict(target_port=80),
                                              dict(target_port=443,
                                                   protocol="udp")])
        r.do(mk_tasks, ["t1", "t2", "t3"])
        r.do(mk_tasks, ["w1", "w2"], svc_id="web")
        r.start()
        r.do(mk_tasks, ["t4"])
    runs = both(scenario)
    tasks, services, networks, nodes = runs[1].image()
    assert networks["net1"]["subnet"] == "172.20.0.0/24"
    assert networks["net1"]["gateway"] == "172.20.0.1"
    assert all(t[0] == int(torch_types.TaskState.PENDING)
               for t in tasks.values())
    assert {n for n, _ in services["web"]["virtual_ips"]} == {"ingress"}
    assert nodes["node1"][0]["network_id"] == "ingress"


def test_task_waits_for_network_then_allocates():
    def scenario(r):
        r.do(mk_service, networks=["backend"])
        r.do(mk_tasks, ["t1"])
        r.start()
        assert r.image()[0]["t1"][0] == int(r.P.t.TaskState.NEW)
        r.do(mk_network)
        assert r.image()[0]["t1"][0] == int(r.P.t.TaskState.PENDING)
    both(scenario)


def test_dead_tasks_return_addresses():
    def scenario(r):
        r.do(mk_network, subnet="192.168.9.0/29")     # gateway + 5 hosts
        r.do(mk_service, networks=["backend"])
        r.do(mk_tasks, ["t1", "t2", "t3", "t4", "t5"])
        r.start()
        r.do(set_task_state, "t2", "FAILED")
        r.do(set_task_state, "t4", "COMPLETE")
        r.do(mk_tasks, ["t6", "t7", "t8"])
    runs = both(scenario, (JAX, TORCH, SCALAR))
    tasks = runs[1].image()[0]
    # t8 found the pool full and waits
    assert tasks["t8"][0] == int(torch_types.TaskState.NEW)
    assert tasks["t2"][3] == () and tasks["t4"][3] == ()


def test_service_created_before_its_network():
    def scenario(r):
        r.do(mk_service, networks=["backend"])
        r.start()
        assert not (r.image()[1]["svc1"] or {}).get("virtual_ips")
        r.do(mk_network)
        assert r.image()[1]["svc1"]["virtual_ips"]
    both(scenario)


def test_dnsrr_releases_vips():
    def scenario(r):
        r.do(mk_network)
        r.do(mk_service, networks=["backend"])
        r.start()
        r.do(flip_dnsrr)
        assert not r.image()[1]["svc1"].get("virtual_ips")
    runs = both(scenario)
    assert len(pools(runs[1].comp)["net1"][0]) == 1      # the gateway


def test_restart_rebuilds_without_double_assignment():
    def scenario(r):
        r.do(mk_network)
        r.do(mk_service, networks=["backend"])
        r.do(mk_tasks, ["t1", "t2"])
        r.start()
        r.start()                        # a new leader on the same store
        r.do(mk_tasks, ["t3", "t4"])
    runs = both(scenario)
    addrs = [a for t in runs[1].image()[0].values() for _, (a,) in t[3]]
    vip = runs[1].image()[1]["svc1"]["virtual_ips"][0][1]
    assert len(set(addrs + [vip])) == 5


@pytest.mark.parametrize("subnet", ["10.50.0.0/24", "10.50.0.0/19"])
@pytest.mark.parametrize("n_tasks", [1, 2, 200, 201])
def test_batched_path_matches_scalar_end_state(n_tasks, subnet):
    """The whole-batch path (one grant per network per chunk of 200;
    a /19 takes the device branch's plain version) lands the scalar
    per-task loop's store, as the JAX package's does."""
    def scenario(r):
        r.do(mk_network, subnet=subnet)
        r.do(mk_service, networks=["net1"], replicas=n_tasks,
             ports=[dict(target_port=80)])
        r.do(mk_tasks, [f"t{i:04d}" for i in range(n_tasks)])
        r.start()
    runs = both(scenario, (JAX, TORCH, SCALAR))
    assert all(t[0] == int(torch_types.TaskState.PENDING)
               for t in runs[1].image()[0].values())


def test_batched_falls_back_on_a_short_pool():
    def scenario(r):
        r.do(mk_network, subnet="10.51.0.0/28")
        r.do(mk_service, networks=["net1"], replicas=20)
        r.do(mk_tasks, [f"t{i:04d}" for i in range(20)])
        r.start()
    runs = both(scenario, (JAX, TORCH, SCALAR))
    states = [t[0] for t in runs[1].image()[0].values()]
    # /28: 13 probe-range hosts, one to the service VIP
    assert states.count(int(torch_types.TaskState.PENDING)) == 12
    assert states.count(int(torch_types.TaskState.NEW)) == 8


def test_batch_commit_failpoint_releases_the_chunk():
    """`alloc.batch.commit` fires after a chunk's grants and before its
    commit: the allocator re-raises with every grant of the chunk back in
    its pool (only the gateway and the VIP held), the tasks stay NEW, and
    a new leader's pass then lands the same store as the JAX package."""
    runs = []
    for P in (JAX, TORCH):
        r = Run(P)
        r.do(mk_network, subnet="10.60.0.0/19")
        r.do(mk_service, networks=["net1"], replicas=230)
        r.do(mk_tasks, [f"t{i:04d}" for i in range(230)])
        with P.fp.armed("alloc.batch.commit",
                        error=RuntimeError("batch crash"), times=2):
            with pytest.raises(RuntimeError, match="batch crash"):
                r.start()
            assert set(pools(r.comp)["net1"][0]) == {"10.60.0.1",
                                                     "10.60.0.2"}
            assert all(t[0] == int(P.t.TaskState.NEW)
                       for t in r.image()[0].values())
            with pytest.raises(RuntimeError, match="batch crash"):
                r.start()
        r.start()
        runs.append(r)
    assert_same(*runs)
    assert all(t[0] == int(torch_types.TaskState.PENDING)
               for t in runs[1].image()[0].values())


def test_live_event_loops_match():
    """Both allocators' event loops over the same scenario: tasks
    created before and after start(), one task dying."""
    runs = [Run(P) for P in (JAX, TORCH)]
    comps = []
    try:
        for r in runs:
            r.do(mk_network, subnet="10.40.0.0/24")
            r.do(mk_service, networks=["backend"])
            r.do(mk_tasks, [f"a{i}" for i in range(5)])
            a = r.P.alloc(r.store)
            comps.append(a)
            a.start()
            assert wait_for(lambda: all_pending(r))
            r.do(set_task_state, "a3", "FAILED")
            assert wait_for(lambda: not r.image()[0]["a3"][3])
            r.do(mk_tasks, [f"b{i}" for i in range(3)])
            assert wait_for(lambda: all_pending(r, "b"))
    finally:
        for a in comps:
            a.stop()
    assert runs[0].image() == runs[1].image()
    assert pools(comps[0]) == pools(comps[1])


def all_pending(r, prefix="a"):
    return all(t[0] == int(r.P.t.TaskState.PENDING)
               for tid, t in r.image()[0].items() if tid.startswith(prefix))


def wait_for(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


@pytest.mark.parametrize("n_tasks", [1, 230])
def test_lifecycle_records_the_moved_tasks(n_tasks):
    """Armed, the lifecycle plane files one PENDING record for each task
    the allocator moved (one batch a call), as the JAX package's does;
    disarmed it records nothing."""
    from swarmkit_tpu.utils import lifecycle as jax_lifecycle
    from swarmkit_tpu_torch.utils import lifecycle as torch_lifecycle

    got = {}
    for P, lc in ((JAX, jax_lifecycle), (TORCH, torch_lifecycle)):
        r = Run(P)
        r.do(mk_network, subnet="10.61.0.0/24")
        r.do(mk_service, networks=["net1"], replicas=n_tasks)
        r.do(mk_tasks, [f"t{i:04d}" for i in range(n_tasks)])
        assert not lc.enabled()
        with lc.armed() as rec:
            assert lc.enabled()
            r.start()
            got[P.name] = {tid: [stage for stage, _ in tl]
                           for tid, tl in rec.timelines().items()}
        assert not lc.enabled()
    assert got["torch"] == got["jax"]
    assert got["torch"] == {f"t{i:04d}": ["PENDING"] for i in range(n_tasks)}


# ------------------------------------------------------------- deallocator
def mark_pending_delete(P, store, kind, obj_id):
    def cb(tx):
        o = getattr(tx, f"get_{kind}")(obj_id).copy()
        o.pending_delete = True
        tx.update(o)
    store.update(cb)


def delete(P, store, kind, obj_id):
    cls = {"task": P.o.Task, "service": P.o.Service}[kind]
    store.update(lambda tx: tx.delete(cls, obj_id))


def test_deallocator_removes_a_service_after_its_tasks():
    def scenario(r):
        r.make = r.P.dealloc
        r.do(mk_service, replicas=2)
        r.do(mk_tasks, ["t1", "t2"])
        r.start()
        r.do(mark_pending_delete, "service", "svc1")
        assert "svc1" in r.image()[1]        # tasks still winding down
        r.do(delete, "task", "t1")
        assert "svc1" in r.image()[1]
        r.do(delete, "task", "t2")
        assert "svc1" not in r.image()[1]
    both(scenario)


def test_deallocator_deletes_a_network_after_its_last_user():
    def scenario(r):
        r.make = r.P.dealloc
        r.do(mk_network, net_id="appnet", name="appnet")
        r.do(mk_service, networks=["appnet"], replicas=0)
        r.start()
        r.do(mark_pending_delete, "network", "appnet")
        assert "appnet" in r.image()[2]      # still referenced
        r.do(delete, "service", "svc1")
        assert "appnet" not in r.image()[2]
    both(scenario)


def test_deallocator_startup_pass_finishes_pending_deletes():
    def scenario(r):
        r.make = r.P.dealloc
        r.do(mk_network, net_id="appnet", name="appnet")
        r.do(mk_service, networks=["appnet"])
        r.do(mark_pending_delete, "network", "appnet")
        r.do(mark_pending_delete, "service", "svc1")
        r.start()
        assert r.image()[1] == {} and r.image()[2] == {}
    both(scenario)
