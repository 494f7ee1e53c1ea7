"""The port's `ReplicatedOrchestrator` on the CPU against the JAX package's:
the rolling-update storm of `tests/test_orchestrator_storm.py` at its fast
sizes, a new leader's startup pass over a store that drifted, node-down
restarts through `restart_many`, and the census's refusal to run without a
card when none is given.

Task ids are random in both packages, so stores are compared by census:
per service, the sorted (slot, desired, observed, node, image) of its
tasks. The storm keeps the reference's invariants and compares the final
stores with the JAX run's; it has no wall-clock gate. Thread tests stop
every orchestrator and pump in a `finally` and bound every wait.
"""
import copy
import random
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_batched_orch import (
    APIS,
    JAX_API,
    JAX_PKG,
    TORCH_API,
    TORCH_PKG,
    _service,
    _task,
    census_calls,  # noqa: F401  (a fixture)
)

rc = TORCH_API.reconcile
POISON = "v2-poison"


@pytest.fixture(autouse=True)
def _batched_plane_on(monkeypatch):
    monkeypatch.delenv("SWARMKIT_TPU_NO_BATCHED_ORCH", raising=False)


def _orchestrator(api, store, **kw):
    if api is TORCH_API:
        kw.setdefault("device", "cpu")
    return api.replicated.ReplicatedOrchestrator(store, **kw)


def _census(api, store):
    out = {}
    for t in store.view(lambda tx: tx.find_tasks()):
        out.setdefault(t.service_id, []).append(
            (t.slot, int(t.desired_state), int(t.status.state), t.node_id,
             t.spec.runtime.image))
    return {k: sorted(v) for k, v in out.items()}


# ------------------------------------------------------------- the storm
class _StormPump(threading.Thread):
    """`tests/test_orchestrator_storm.py`'s fake agents: desired-RUNNING
    tasks start, except poisoned images, which FAIL; shutdowns are
    observed stopped."""

    def __init__(self, api, store):
        super().__init__(daemon=True, name="storm-pump")
        self.api, self.store = api, store
        self._halt = threading.Event()

    def stop(self):
        self._halt.set()
        self.join(timeout=5)

    def run(self):
        ts = self.api.types.TaskState
        while not self._halt.is_set():
            def cb(tx):
                for t in tx.find_tasks():
                    if t.desired_state == ts.RUNNING \
                            and t.status.state < ts.RUNNING:
                        c = t.copy()
                        c.status.state = (ts.FAILED
                                          if t.spec.runtime.image == POISON
                                          else ts.RUNNING)
                        tx.update(c)
                    elif t.desired_state >= ts.SHUTDOWN \
                            and t.status.state <= ts.RUNNING:
                        c = t.copy()
                        c.status.state = ts.SHUTDOWN
                        tx.update(c)

            try:
                self.store.update(cb)
            except Exception:
                pass
            self._halt.wait(0.02)


def _storm_service(api, sid, replicas):
    sp, t = api.specs, api.types
    svc = api.objects.Service(id=sid)
    svc.spec = sp.ServiceSpec(
        annotations=sp.Annotations(name=sid), replicas=replicas,
        task=sp.TaskSpec(runtime=sp.ContainerSpec(image="v1"),
                         restart=sp.RestartPolicy(delay=0.05)),
        update=sp.UpdateConfig(
            parallelism=2, delay=0.0, monitor=0.3,
            order=t.UpdateOrder.STOP_FIRST,
            failure_action=t.UpdateFailureAction.ROLLBACK,
            max_failure_ratio=0.0))
    svc.spec_version = api.objects.Version(1)
    return svc


def _push(api, store, sid, image):
    cur = store.view(lambda tx: tx.get_service(sid))
    new = cur.copy()
    new.previous_spec = copy.deepcopy(cur.spec)
    new.spec = copy.deepcopy(cur.spec)
    new.spec.task.runtime.image = image
    new.spec_version = api.objects.Version(cur.spec_version.index + 1)
    store.update(lambda tx: tx.update(new))


def _converged(api, store, sid, poisoned):
    ts = api.types.TaskState
    svc = store.view(lambda tx: tx.get_service(sid))
    if (svc.update_status or {}).get("state") != \
            ("rollback_completed" if poisoned else "completed"):
        return False
    run = [t for t in store.view(
        lambda tx: tx.find_tasks(api.by.ByServiceID(sid)))
        if t.desired_state <= ts.RUNNING and t.status.state == ts.RUNNING]
    want = "v1" if poisoned else "v2"
    return (len({t.slot for t in run}) == svc.spec.replicas
            and all(t.spec.runtime.image == want for t in run))


def _wait(cond, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def run_storm(api, seed, n_services, replicas, budget_s):
    """One seeded storm on `api`'s orchestrator; returns its outcome: per
    service, the final status, spec image and the distinct live slots."""
    ts = api.types.TaskState
    rng = random.Random(seed)
    store = api.memory.MemoryStore()
    orch = _orchestrator(api, store)
    assert orch.batched is not None
    pump = _StormPump(api, store)
    ids = [f"storm-{seed}-{i:03d}" for i in range(n_services)]
    poisoned = {sid for sid in ids if rng.random() < 0.3}
    try:
        orch.start()
        pump.start()
        store.update(lambda tx: [tx.create(_storm_service(api, sid, replicas))
                                 for sid in ids])

        def all_v1_up():
            return len([t for t in store.view(lambda tx: tx.find_tasks())
                        if t.status.state == ts.RUNNING
                        and t.desired_state <= ts.RUNNING]) \
                == n_services * replicas

        assert _wait(all_v1_up, budget_s), "v1 fleet never converged"
        for sid in ids:     # the storm: every service flips in one burst
            _push(api, store, sid, POISON if sid in poisoned else "v2")
        assert _wait(lambda: all(_converged(api, store, sid, sid in poisoned)
                                 for sid in ids), budget_s), \
            f"storm never converged ({api.name}, seed {seed})"
        out = {}
        for sid in ids:
            live = [t for t in store.view(
                lambda tx, sid=sid: tx.find_tasks(api.by.ByServiceID(sid)))
                if t.desired_state <= ts.RUNNING]
            slots = [t.slot for t in live]
            assert len(set(slots)) == replicas, (sid, sorted(slots))
            svc = store.view(lambda tx, sid=sid: tx.get_service(sid))
            out[sid] = (sid in poisoned, svc.update_status["state"],
                        svc.spec.task.runtime.image, sorted(set(slots)))
        tasks = store.view(lambda tx: tx.find_tasks())
        services = store.view(lambda tx: tx.find_services())
        rebuilt = api.columnar.ColumnarTasks.rebuild(tasks, services=services)
        assert api.columnar.ColumnarTasks.snapshots_equal(
            store.columnar.snapshot(), rebuilt.snapshot())
        return out, len(poisoned)
    finally:
        pump.stop()
        orch.stop()


@pytest.mark.parametrize("seed", range(2))
def test_update_storm_fast(seed):
    """`tests/test_orchestrator_storm.py::test_update_storm_fast` at 6
    services x 3 replicas: poisoned services roll back to v1
    (ROLLBACK_COMPLETED), the others complete on v2; exact replica counts,
    no slot twice, the columnar mirror equal to a rebuild; the same final
    stores as the JAX package's run."""
    got, n_poisoned = run_storm(TORCH_API, seed, 6, 3, 60.0)
    want, _ = run_storm(JAX_API, seed, 6, 3, 60.0)
    assert got == want
    for poisoned, state, image, slots in got.values():
        assert (state, image) == (("rollback_completed", "v1") if poisoned
                                  else ("completed", "v2"))
        assert slots == [1, 2, 3]
    assert n_poisoned == sum(v[0] for v in got.values())


# ------------------------------------------------- the startup drift
def drifted_store(api, seed=5, n_services=24, n_nodes=6):
    """A converged cluster (a RUNNING task in each slot of each replicated
    service, on nodes n0..n5), then the drift a new leader inherits: some
    services scaled up or down, some tasks FAILED with desired RUNNING,
    some services on a new spec (dirty slots), one slot holding two
    tasks, a global service beside them."""
    o, t = api.objects, api.types
    rng = random.Random(seed)
    store = api.memory.MemoryStore()

    def converged(tx):
        for i in range(n_nodes):
            n = o.Node(id=f"n{i}")
            n.status.state = t.NodeStatusState.READY
            n.spec.availability = t.NodeAvailability.ACTIVE
            tx.create(n)
        tx.create(_service(api, "glob", 0, mode=t.ServiceMode.GLOBAL))
        for s in range(n_services):
            svc = _service(api, f"svc{s:02d}", rng.randrange(1, 6))
            tx.create(svc)
            for slot in range(1, svc.spec.replicas + 1):
                tx.create(_task(api, f"t{s:02d}-{slot}", svc, slot,
                                node=f"n{rng.randrange(n_nodes)}"))

    def drift(tx):
        for svc in sorted(tx.find_services(), key=lambda x: x.id):
            if svc.id == "glob":
                continue
            roll = rng.random()
            cur = svc.copy()
            if roll < 0.25:
                cur.spec.replicas += 2
            elif roll < 0.45:
                cur.spec.replicas = max(cur.spec.replicas - 1, 0)
            elif roll < 0.6:
                cur.spec.task.runtime.image = "v2"
                cur.spec_version = o.Version(cur.spec_version.index + 1)
            tx.update(cur)
        for task in sorted(tx.find_tasks(), key=lambda x: x.id):
            if rng.random() < 0.12:
                c = task.copy()
                c.status.state = t.TaskState.FAILED
                tx.update(c)
        svc = tx.get_service("svc00")
        extra = _task(api, "t00-dup", svc, 1, node="n0",
                      state=t.TaskState.PENDING)
        tx.create(extra)

    store.update(converged)
    store.update(drift)
    return store


def _startup(api, store):
    """A new leader's on_start on the store (restarts on a FakeClock, the
    update supervisor's calls recorded), then nodes n1 and n4 down through
    the node handler (restart_many). Returns the censuses after each, the
    update calls and the restart history totals."""
    orch = _orchestrator(api, store)
    orch.restart._clock = api.clock.FakeClock()
    updates = []
    orch.updater.update = lambda svc, ds: updates.append(
        (svc.id, [sorted(t.id for t in ts) for ts in ds]))
    try:
        services, ch = store.view_and_watch(orch.setup, limit=None)
        store.queue.stop_watch(ch)
        orch.on_start(services)
        after_start = _census(api, store)
        for nid in ("n1", "n4"):
            def down(tx, nid=nid):
                n = tx.get_node(nid).copy()
                n.status.state = api.types.NodeStatusState.DOWN
                tx.update(n)
            store.update(down)
            orch.handle(api.objects.EventUpdate(
                obj=store.view(lambda tx, nid=nid: tx.get_node(nid))))
        history = {k: v.total_restarts
                   for k, v in orch.restart._history.items()}
        return after_start, _census(api, store), sorted(updates), history
    finally:
        orch.stop()


@pytest.mark.parametrize("branch", ["numpy", "kernel"])
def test_startup_drift_matches_jax(branch, monkeypatch, census_calls):
    """on_start (check_tasks, then one batched reconcile over every
    replicated service) and two node-down restarts give the same stores,
    update calls and restart history as the JAX package's, on both of the
    census's CPU branches; a second leader's census then finds no slot to
    create or remove."""
    if branch == "kernel":
        monkeypatch.setattr(rc, "DIFF_THRESHOLD", 1)
    got = {api.name: _startup(api, drifted_store(api)) for api in APIS}
    assert got[TORCH_PKG] == got[JAX_PKG]
    after_start, after_down, updates, history = got[TORCH_PKG]
    assert updates and history
    assert census_calls["plain" if branch == "kernel" else "np"] == 1
    assert after_start != _census(TORCH_API, drifted_store(TORCH_API))

    store = drifted_store(TORCH_API)
    _startup(TORCH_API, store)
    ids = [s.id for s in store.view(lambda tx: tx.find_services())]
    second = TORCH_API.batched.BatchedReconciler(store, device="cpu")
    assert not any(d.actionable for d in second.decide_many(ids).values())


def test_handle_routes_events_like_jax():
    """Service creates, task deaths and deletes go through handle() and
    flush_events() (the coalesced batched pass) to the same stores."""
    out = {}
    for api in APIS:
        t = api.types
        store = api.memory.MemoryStore()
        orch = _orchestrator(api, store)
        orch.restart._clock = api.clock.FakeClock()
        try:
            svcs = [_service(api, f"s{i}", i + 1) for i in range(6)]
            store.update(lambda tx: [tx.create(s) for s in svcs])
            for s in svcs:
                orch.handle(api.objects.EventCreate(obj=s))
            orch.flush_events()
            first = _census(api, store)
            victim = sorted(store.view(lambda tx: tx.find_tasks()),
                            key=lambda x: (x.service_id, x.slot))[3]
            dead = victim.copy()
            dead.status.state = t.TaskState.FAILED
            store.update(lambda tx: tx.update(dead))
            orch.handle(api.objects.EventUpdate(obj=dead))
            gone = store.view(lambda tx: tx.get_service("s5"))
            store.update(lambda tx: tx.delete(api.objects.Service, "s5"))
            orch.handle(api.objects.EventDelete(obj=gone))
            out[api.name] = (first, _census(api, store))
        finally:
            orch.stop()
    assert out[TORCH_PKG] == out[JAX_PKG]
    assert sum(len(v) for v in out[TORCH_PKG][0].values()) == 21


# ------------------------------------------------ no card, no fallback
def test_census_without_a_device_raises(monkeypatch):
    """From DIFF_THRESHOLD cells the census runs on the card: with no
    device given and no CUDA it raises, directly and through a new
    leader's on_start; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    one = np.zeros(1, np.int32)
    flag = np.ones(1, bool)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rc.compute_slot_state(one, one, flag, flag, 1, rc.DIFF_THRESHOLD)
    # below the threshold numpy answers, with or without a card
    rc.compute_slot_state(one, one, flag, flag, 1, 8)

    monkeypatch.setattr(rc, "DIFF_THRESHOLD", 1)
    store = TORCH_API.memory.MemoryStore()
    store.update(lambda tx: [tx.create(_service(TORCH_API, f"s{i}", 2))
                             for i in range(8)])
    orch = TORCH_API.replicated.ReplicatedOrchestrator(store)
    orch.restart._clock = TORCH_API.clock.FakeClock()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            orch.on_start(store.view(orch.setup))
    finally:
        orch.stop()
    assert not store.view(lambda tx: tx.find_tasks())
