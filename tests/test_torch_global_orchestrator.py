"""The port's `GlobalOrchestrator` (store, startup check, bulk reconcile on
`ops.reconcile.compute_diff`, event handlers) against the JAX package's, on
the same seeded clusters, on the CPU.

Task ids are random in both packages, so a store is compared by its
snapshot: for each (service, node) pair, the sorted (desired, observed)
states of its tasks. The restart supervisors of both run on a `FakeClock`
each (the port's and the JAX package's), so no timer thread starts and the
restart delay passes when the test advances the clock.
"""
import importlib
import random
import time
import types

import pytest

JAX_PKG, TORCH_PKG = "swarmkit_tpu", "swarmkit_tpu_torch"


def _api(pkg: str):
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        objects=mod("api.objects"), types=mod("api.types"),
        specs=mod("api.specs"), memory=mod("store.memory"),
        by=mod("store.by"), global_=mod("orchestrator.global_"),
        clock=mod("utils.clock"), reconcile=mod("ops.reconcile"),
        lifecycle=mod("utils.lifecycle"))


JAX_API, TORCH_API = _api(JAX_PKG), _api(TORCH_PKG)


def _orch(api, store, **kw):
    orch = api.global_.GlobalOrchestrator(store, **kw)
    orch.restart._clock = api.clock.FakeClock()
    return orch


def _kw(api):
    return {"device": "cpu"} if api is TORCH_API else {}


def _snapshot(store):
    out = {}
    for t in store.view().find_tasks():
        out.setdefault((t.service_id, t.node_id), []).append(
            (int(t.desired_state), int(t.status.state)))
    return {k: sorted(v) for k, v in out.items()}


def small_cluster(api, store):
    """`tests/test_reconcile_kernel.py`'s `_build_cluster`: 12 nodes, 4
    global services (every other one pinned to zone a), one task."""
    o, t = api.objects, api.types
    rng = random.Random(3)

    def cb(tx):
        for i in range(12):
            n = o.Node(id=f"node-{i:03d}")
            ready = rng.random() < 0.7
            n.status.state = (t.NodeStatusState.READY if ready
                              else t.NodeStatusState.DOWN)
            n.spec.availability = t.NodeAvailability.ACTIVE
            n.spec.annotations.labels = {"zone": "ab"[i % 2]}
            tx.create(n)
        for si in range(4):
            s = o.Service(id=f"gsvc-{si}", spec=api.specs.ServiceSpec(
                mode=t.ServiceMode.GLOBAL))
            s.spec.annotations.name = f"gsvc-{si}"
            if si % 2:
                s.spec.task.placement.constraints = ["node.labels.zone == a"]
            tx.create(s)
        task = o.Task(id="pre-0", service_id="gsvc-0", node_id="node-000")
        task.desired_state = t.TaskState.RUNNING
        task.status.state = t.TaskState.RUNNING
        tx.create(task)

    store.update(cb)


def churned_cluster(api, store, seed=7, n_nodes=80, n_services=6):
    """A converged cluster (one RUNNING task per eligible (service, node);
    services pinned to one of four zones or to none, one replicated
    service beside them) after churn: drained, paused, down and unknown
    nodes, new READY nodes, failed and shut-down tasks, a task on a node
    that no longer exists."""
    o, t = api.objects, api.types
    rng = random.Random(seed)

    def cb(tx):
        zones = {}
        for i in range(n_nodes):
            n = o.Node(id=f"n-{i:04d}")
            n.status.state = t.NodeStatusState.READY
            n.spec.availability = t.NodeAvailability.ACTIVE
            zones[n.id] = f"z{i % 4}"
            n.spec.annotations.labels = {"zone": zones[n.id]}
            tx.create(n)
        svcs = []
        for si in range(n_services):
            s = o.Service(id=f"g-{si}", spec=api.specs.ServiceSpec(
                mode=t.ServiceMode.GLOBAL))
            s.spec.annotations.name = f"g-{si}"
            zone = None if si == 0 else f"z{si % 4}"
            if zone:
                s.spec.task.placement.constraints = [
                    f"node.labels.zone == {zone}"]
            tx.create(s)
            svcs.append((s.id, zone))
        rep = o.Service(id="r-0", spec=api.specs.ServiceSpec(
            mode=t.ServiceMode.REPLICATED))
        rep.spec.annotations.name = "r-0"
        tx.create(rep)
        k = 0
        for sid, zone in svcs:
            for nid, z in zones.items():
                if zone is None or z == zone:
                    task = o.Task(id=f"t-{k:05d}", service_id=sid,
                                  node_id=nid)
                    task.desired_state = t.TaskState.RUNNING
                    task.status.state = t.TaskState.RUNNING
                    tx.create(task)
                    k += 1
        task = o.Task(id="t-ghost", service_id="g-0", node_id="n-gone")
        task.desired_state = t.TaskState.RUNNING
        task.status.state = t.TaskState.RUNNING
        tx.create(task)

    store.update(cb)

    def churn(tx):
        for n in tx.find_nodes():
            roll = rng.random()
            if roll < 0.25:
                n = n.copy()
                if roll < 0.06:
                    n.spec.availability = t.NodeAvailability.DRAIN
                elif roll < 0.12:
                    n.status.state = t.NodeStatusState.DOWN
                elif roll < 0.17:
                    n.spec.availability = t.NodeAvailability.PAUSE
                elif roll < 0.21:
                    n.status.state = t.NodeStatusState.UNKNOWN
                else:
                    n.spec.annotations.labels = {"zone": "z9"}
                tx.update(n)
        for i in range(6):
            n = o.Node(id=f"n-new-{i}")
            n.status.state = t.NodeStatusState.READY
            n.spec.availability = t.NodeAvailability.ACTIVE
            n.spec.annotations.labels = {"zone": f"z{i % 4}"}
            tx.create(n)
        for task in tx.find_tasks():
            roll = rng.random()
            if roll < 0.05:
                task = task.copy()
                task.status.state = t.TaskState.FAILED
                tx.update(task)
            elif roll < 0.08:
                task = task.copy()
                task.desired_state = t.TaskState.SHUTDOWN
                tx.update(task)

    store.update(churn)


CLUSTERS = {"small": small_cluster, "churned": churned_cluster}


def _services(store):
    return [s.id for s in store.view().find_services()]


@pytest.fixture
def spy_kernel_route(monkeypatch):
    """Counts the calls of the port's kernel route (the plain version of
    K14 on the CPU)."""
    calls = []
    real = TORCH_API.reconcile.global_diff_plain
    monkeypatch.setattr(TORCH_API.reconcile, "global_diff_plain",
                        lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize("branch", ["numpy", "kernel"])
@pytest.mark.parametrize("cluster", list(CLUSTERS))
def test_bulk_reconcile_matches_jax_and_the_walk(cluster, branch,
                                                 monkeypatch,
                                                 spy_kernel_route):
    """bulk_reconcile on both branches of compute_diff: the same snapshot
    as the JAX package's bulk_reconcile and as the port's per-service
    walk; a second pass changes nothing."""
    if branch == "kernel":
        monkeypatch.setattr(TORCH_API.reconcile, "DIFF_THRESHOLD", 1)
    snaps = {}
    for name, api, bulk in (("jax", JAX_API, True), ("port", TORCH_API, True),
                            ("walk", TORCH_API, False)):
        store = api.memory.MemoryStore()
        CLUSTERS[cluster](api, store)
        orch = _orch(api, store, **_kw(api))
        sids = _services(store)
        if bulk:
            orch.bulk_reconcile(sids)
        else:
            for sid in sids:
                orch.reconcile_service(sid)
        snaps[name] = _snapshot(store)
        if name == "port":
            orch.bulk_reconcile(sids)
            assert _snapshot(store) == snaps["port"]      # idempotent
        orch.stop()
    assert snaps["port"] == snaps["jax"]
    assert set(snaps["port"]) == set(snaps["walk"])
    for k, v in snaps["port"].items():
        assert [d for d, _ in v] == [d for d, _ in snaps["walk"][k]], k
    # two diffs a pass (create, shutdown), two passes
    assert len(spy_kernel_route) == (4 if branch == "kernel" else 0)


def test_on_start_matches_jax():
    """The startup path a new leader runs: setup under view_and_watch,
    then check_tasks (restarts of the dead and stranded tasks) and the
    bulk reconcile; then the restart delay passes."""
    snaps = []
    for api in (JAX_API, TORCH_API):
        store = api.memory.MemoryStore()
        churned_cluster(api, store)
        orch = _orch(api, store, **_kw(api))
        services, ch = store.view_and_watch(orch.setup)
        try:
            orch.on_start(services)
            first = _snapshot(store)
            assert orch.restart._delays         # restarts are armed
            orch.restart._clock.advance(10.0)
            snaps.append((first, _snapshot(store)))
        finally:
            store.queue.stop_watch(ch)
            orch.stop()
    assert snaps[0] == snaps[1]
    promoted = snaps[1][1]
    assert any(int(TORCH_API.types.TaskState.READY) in [d for d, _ in v]
               for v in snaps[1][0].values())
    assert not any(int(TORCH_API.types.TaskState.READY) in [d for d, _ in v]
                   for v in promoted.values())


def _events(api, store):
    """The handler steps: each changes the store, then hands the
    orchestrator the event, as its loop would."""
    o, t, by = api.objects, api.types, api.by
    tx = store.view()

    def update_node(nid, **kw):
        def cb(wtx):
            n = wtx.get_node(nid).copy()
            for k, v in kw.items():
                if k == "availability":
                    n.spec.availability = v
                else:
                    n.status.state = v
            wtx.update(n)
        store.update(cb)
        return o.EventUpdate(store.view().get_node(nid))

    def delete(cls, oid):
        obj = store.view().get(cls, oid)
        store.update(lambda wtx: wtx.delete(cls, oid))
        return o.EventDelete(obj)

    def fail_task(sid):
        # the first node's running task; task ids are random, so the pick
        # is made by what the snapshot compares and never by id
        task = min((x for x in store.view().find_tasks(by.ByServiceID(sid))
                    if x.desired_state == t.TaskState.RUNNING),
                   key=lambda x: (x.node_id, int(x.status.state))).copy()
        task.status.state = t.TaskState.FAILED
        store.update(lambda wtx: wtx.update(task))
        return o.EventUpdate(store.view().get_task(task.id))

    nodes = sorted(n.id for n in tx.find_nodes())
    return [
        lambda: update_node(nodes[1], availability=t.NodeAvailability.DRAIN),
        lambda: update_node(nodes[1], availability=t.NodeAvailability.ACTIVE),
        lambda: update_node(nodes[2], state=t.NodeStatusState.DOWN),
        lambda: delete(o.Node, nodes[3]),
        lambda: delete(o.Service, "g-2"),
        lambda: fail_task("g-0"),
        lambda: fail_task("g-1"),
    ]


def test_handlers_match_jax():
    """handle() for a node update (drain, then back), a node going down, a
    node delete, a service delete and two task failures, each step's
    snapshot equal to the JAX package's; then the restart delay passes."""
    runs = []
    for api in (JAX_API, TORCH_API):
        store = api.memory.MemoryStore()
        churned_cluster(api, store, n_nodes=40, n_services=4)
        orch = _orch(api, store, **_kw(api))
        try:
            orch.bulk_reconcile(_services(store))
            snaps = [_snapshot(store)]
            for step in _events(api, store):
                orch.handle(step())
                snaps.append(_snapshot(store))
            orch.restart._clock.advance(10.0)
            snaps.append(_snapshot(store))
        finally:
            orch.stop()
        runs.append(snaps)
    assert len(runs[0]) == len(runs[1])
    for i, (w, g) in enumerate(zip(*runs)):
        assert g == w, f"step {i}"
    assert runs[1][4] != runs[1][5]          # the service delete did work


def test_lifecycle_records_match_jax():
    """With the lifecycle recorder armed, the startup reconcile files NEW
    for each task it creates, and draining the new nodes files SHUTDOWN
    for those tasks, which were never assigned: per (service, node), the
    same stages as the JAX package's; disarmed again afterwards."""
    runs = []
    for api in (JAX_API, TORCH_API):
        store = api.memory.MemoryStore()
        churned_cluster(api, store, n_nodes=40, n_services=4)
        orch = _orch(api, store, **_kw(api))
        try:
            with api.lifecycle.armed() as rec:
                orch.bulk_reconcile(_services(store))
                for i in range(6):
                    nid = f"n-new-{i}"

                    def drain(tx, nid=nid):
                        n = tx.get_node(nid).copy()
                        n.spec.availability = \
                            api.types.NodeAvailability.DRAIN
                        tx.update(n)
                    store.update(drain)
                    orch.handle(api.objects.EventUpdate(
                        store.view().get_node(nid)))
            assert api.lifecycle._REC is None
        finally:
            orch.stop()
        where = {t.id: (t.service_id, t.node_id)
                 for t in store.view().find_tasks()}
        stages = {}
        for tid, tl in rec.timelines().items():
            stages.setdefault(where[tid], []).append(
                tuple(stage for stage, _ in tl))
        runs.append({k: sorted(v) for k, v in stages.items()})
    assert runs[1] == runs[0]
    assert ("NEW", "SHUTDOWN") in [tl for v in runs[1].values() for tl in v]


def test_start_stop_reconciles_a_new_node():
    """One start()/stop() of the event loop: the startup reconcile runs on
    the thread, a node created afterwards gets its tasks, and stop() joins
    the thread."""
    api = TORCH_API
    store = api.memory.MemoryStore()
    small_cluster(api, store)
    orch = _orch(api, store, device="cpu")
    try:
        orch.start()
        want = {s.id for s in store.view().find_services()
                if not s.spec.task.placement.constraints}

        def node(tx):
            n = api.objects.Node(id="node-new")
            n.status.state = api.types.NodeStatusState.READY
            n.spec.annotations.labels = {"zone": "b"}
            tx.create(n)

        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:      # the startup pass first
            if any(t.node_id == "node-002"
                   for t in store.view().find_tasks()):
                break
            time.sleep(0.01)
        store.update(node)
        while time.monotonic() < deadline:
            got = {t.service_id for t in store.view().find_tasks(
                api.by.ByNodeID("node-new"))}
            if got == want:
                break
            time.sleep(0.01)
        assert got == want
    finally:
        orch.stop()
    assert not orch._thread.is_alive()
    assert not store.queue.has_watchers()


def test_kernel_branch_without_a_device_raises(monkeypatch):
    """GlobalOrchestrator() with no device runs the diff on the card at or
    above the threshold, and raises where there is none."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(TORCH_API.reconcile, "DIFF_THRESHOLD", 1)
    store = TORCH_API.memory.MemoryStore()
    small_cluster(TORCH_API, store)
    orch = _orch(TORCH_API, store)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            orch.bulk_reconcile(_services(store))
    finally:
        orch.stop()
    assert [t.id for t in store.view().find_tasks()] == ["pre-0"]
