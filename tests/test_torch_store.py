"""The port's store (`swarmkit_tpu_torch.store`: memory, by, watch,
columnar) against the JAX package's, on one seeded differential trace.

Both stores, each with its own `LocalProposer`, take the same operations:
creates, updates and deletes of nodes, services and tasks, name clashes,
a stale write, `batch()` (past one transaction's change limit),
`view_and_watch` and the `by` selectors. Each run writes a transcript of
everything a caller can observe (object fields and versions, raised
errors, the watch events in order, the store version, the columnar image)
and the two transcripts must be equal. Task ids are fixed by the trace, so
the two stores hold the same ids.
"""
import importlib
import random
import types

import numpy as np
import pytest


def _api(pkg: str):
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        objects=mod("api.objects"), types=mod("api.types"),
        specs=mod("api.specs"), memory=mod("store.memory"),
        by=mod("store.by"), proposer=mod("state.proposer"))


JAX_API, TORCH_API = _api("swarmkit_tpu"), _api("swarmkit_tpu_torch")


def _obj(o):
    """What a caller can observe of a store object, timestamps aside."""
    base = (o.TABLE, o.id, o.meta.version.index)
    if o.TABLE == "task":
        return base + (o.service_id, o.node_id, o.slot,
                       int(o.desired_state), int(o.status.state))
    if o.TABLE == "node":
        return base + (int(o.status.state), int(o.spec.availability),
                       tuple(sorted((o.spec.annotations.labels or {})
                                    .items())), o.spec.annotations.name)
    if o.TABLE == "service":
        return base + (o.spec.annotations.name, o.spec.mode.name,
                       o.spec_version.index if o.spec_version else None)
    return base


def _event(ev):
    obj = getattr(ev, "obj", None)
    if obj is None:                       # EventCommit
        return (type(ev).__name__, ev.version.index)
    return (type(ev).__name__, _obj(obj))


class _Trace:
    """One store driven through the seeded operations, writing down what
    it observes."""

    def __init__(self, api, seed):
        self.api = api
        self.rng = random.Random(seed)
        self.store = api.memory.MemoryStore(
            proposer=api.proposer.LocalProposer())
        self.out = []
        self.nodes, self.services, self.tasks = [], [], []

    def note(self, *what):
        self.out.append(what)

    def write(self, cb):
        """One update transaction; records the error class it raised."""
        try:
            self.store.update(cb)
            self.note("ok", self.store.version.index)
        except Exception as e:            # noqa: BLE001
            self.note("error", type(e).__name__)

    # -- object factories (the same fields on either package) ---------------
    def node(self, i):
        o, t = self.api.objects, self.api.types
        n = o.Node(id=f"node-{i:03d}")
        n.status.state = self.rng.choice([t.NodeStatusState.READY,
                                          t.NodeStatusState.DOWN])
        n.spec.availability = self.rng.choice(list(t.NodeAvailability))
        n.spec.annotations.name = f"host-{i % 7}"      # names clash
        n.spec.annotations.labels = {"zone": "abc"[i % 3]}
        return n

    def service(self, i):
        o, t = self.api.objects, self.api.types
        s = o.Service(id=f"svc-{i}", spec=self.api.specs.ServiceSpec(
            mode=self.rng.choice([t.ServiceMode.GLOBAL,
                                  t.ServiceMode.REPLICATED])))
        s.spec.annotations.name = f"web-{i % 4}"
        return s

    def task(self, i):
        o, t = self.api.objects, self.api.types
        task = o.Task(id=f"task-{i:04d}",
                      service_id=self.rng.choice(self.services),
                      node_id=self.rng.choice(self.nodes + [""]))
        task.slot = self.rng.randrange(4)
        task.desired_state = self.rng.choice([t.TaskState.RUNNING,
                                              t.TaskState.SHUTDOWN])
        task.status.state = self.rng.choice([t.TaskState.NEW,
                                             t.TaskState.RUNNING,
                                             t.TaskState.FAILED])
        return task

    # -- the trace --------------------------------------------------------------
    def run(self):
        api, store = self.api, self.store
        t = api.types
        first = store.queue.watch()       # sees every event from the start
        made = []
        for i in range(12):                # nodes 7-11 clash by name
            n = self.node(i)
            self.write(lambda tx, n=n: tx.create(n))
            if store.view().get_node(n.id) is not None:
                self.nodes.append(n.id)
                made.append(n)
        for i in range(6):                 # services 4 and 5 clash
            s = self.service(i)
            self.write(lambda tx, s=s: tx.create(s))
            if store.view().get_service(s.id) is not None:
                self.services.append(s.id)
        # the creates copied: mutating the caller's object changes nothing
        made[0].status.state = t.NodeStatusState.UNKNOWN
        self.note("isolated", _obj(store.view().get_node(made[0].id)))

        def many(batch):
            for i in range(250):           # two transactions of <= 200
                task = self.task(i)
                batch.update(lambda tx, task=task: tx.create(task))
                self.tasks.append(task.id)

        store.batch(many)
        self.note("batched", store.version.index)

        snap, ch = store.view_and_watch(
            lambda tx: [_obj(x) for x in tx.find_tasks(
                api.by.ByServiceID(self.services[0]))])
        self.note("snapshot", snap)
        for step in range(120):
            kind = self.rng.randrange(6)
            tid = self.rng.choice(self.tasks)
            if kind <= 2:                  # update a task
                def cb(tx, tid=tid):
                    cur = tx.get_task(tid)
                    if cur is None:
                        return
                    cur = cur.copy()
                    cur.status.state = self.rng.choice(list(t.TaskState))
                    cur.node_id = self.rng.choice(self.nodes)
                    tx.update(cur)
                self.write(cb)
            elif kind == 3:                # delete a task (maybe again)
                self.write(lambda tx, tid=tid: tx.delete(api.objects.Task,
                                                         tid))
            elif kind == 4:                # update a node, maybe renamed
                nid = self.rng.choice(self.nodes)

                def cb(tx, nid=nid):
                    cur = tx.get_node(nid).copy()
                    cur.spec.availability = self.rng.choice(
                        list(t.NodeAvailability))
                    if self.rng.random() < 0.3:
                        cur.spec.annotations.name = \
                            f"host-{self.rng.randrange(9)}"
                    tx.update(cur)
                self.write(cb)
            else:                          # a stale write
                sid = self.rng.choice(self.services)
                old = store.view().get_service(sid).copy()

                def bump(tx, sid=sid):
                    cur = tx.get_service(sid).copy()
                    cur.spec_version = api.objects.Version(step)
                    tx.update(cur)
                self.write(bump)
                self.write(lambda tx, old=old: tx.update(old))
        # duplicate creates and deletes of what is not there
        self.write(lambda tx: tx.create(self.service(0)))
        self.write(lambda tx: tx.delete(api.objects.Node, "node-999"))
        # a service and node deleted
        self.write(lambda tx: tx.delete(api.objects.Service,
                                        self.services[-1]))
        self.write(lambda tx: tx.delete(api.objects.Node, self.nodes[-1]))
        self.selectors()
        self.note("events", [_event(e) for e in ch.drain()])
        self.note("all_events", [_event(e) for e in first.drain()])
        store.queue.stop_watch(ch)
        store.queue.stop_watch(first)
        col = store.columnar.snapshot()
        self.note("columnar", {k: (v.tolist() if isinstance(v, np.ndarray)
                                   else v) for k, v in col.items()})
        return self.out

    def selectors(self):
        by, t, tx = self.api.by, self.api.types, self.store.view()
        sid, nid = self.services[1], self.nodes[2]
        finds = {
            "service": tx.find_tasks(by.ByServiceID(sid)),
            "node": tx.find_tasks(by.ByNodeID(nid)),
            "slot": tx.find_tasks(by.BySlot(sid, 2)),
            "desired": tx.find_tasks(by.ByDesiredState(t.TaskState.RUNNING)),
            "state": tx.find_tasks(by.ByTaskState(t.TaskState.FAILED)),
            "name": tx.find_nodes(by.ByName("HOST-1")),
            "name_prefix": tx.find_services(by.ByNamePrefix("web-")),
            "id_prefix": tx.find_tasks(by.ByIDPrefix("task-00")),
            "or": tx.find_tasks(by.Or(by.ByNodeID(nid),
                                      by.ByServiceID(sid))),
            "all": tx.find_nodes(),
        }
        for name, objs in finds.items():
            self.note("find", name, [_obj(o) for o in objs])


@pytest.mark.parametrize("seed", [0, 1])
def test_store_trace_matches_jax(seed):
    want = _Trace(JAX_API, seed).run()
    got = _Trace(TORCH_API, seed).run()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    kinds = {w[1] for w in want if w[0] == "error"}
    assert {"SequenceConflict", "ExistError", "NotExistError"} <= kinds


def test_store_write_isolation():
    """A caller that mutates what it read or wrote does not change the
    store: creates and updates copy, and a read's copy is the caller's."""
    api = TORCH_API
    store = api.memory.MemoryStore()
    n = api.objects.Node(id="n1")
    n.spec.annotations.labels = {"zone": "a"}
    store.update(lambda tx: tx.create(n))
    n.spec.annotations.labels["zone"] = "b"
    cur = store.view().get_node("n1").copy()
    cur.spec.annotations.labels["zone"] = "c"
    assert store.view().get_node("n1").spec.annotations.labels == \
        {"zone": "a"}
    store.update(lambda tx: tx.update(cur))
    cur.spec.annotations.labels["zone"] = "d"
    got = store.view().get_node("n1")
    assert got.spec.annotations.labels == {"zone": "c"}
    assert got.meta.version.index == 2


def test_store_times_its_transactions():
    """Each view with a callback files one read-latency sample, each
    update one write-latency and one lock-hold sample, in the port's
    histograms as in the JAX package's."""
    for api in (JAX_API, TORCH_API):
        mem = api.memory
        hists = (mem._read_tx_latency, mem._write_tx_latency, mem._lock_hold)
        before = [h.snapshot()[2] for h in hists]
        store = mem.MemoryStore()
        for i in range(3):
            store.update(lambda tx, i=i: tx.create(api.objects.Node(
                id=f"n{i}")))
        assert store.view(lambda tx: len(tx.find_nodes())) == 3
        after = [h.snapshot()[2] for h in hists]
        assert [a - b for a, b in zip(after, before)] == [1, 3, 3]
