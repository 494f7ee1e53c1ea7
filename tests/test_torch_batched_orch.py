"""The port's batched orchestration plane (`orchestrator/batched.py`, the
slot census K18 in `ops/reconcile.py`, `RestartSupervisor.restart_many`,
the `UpdateWavePlanner` and the threaded `Updater`) against the JAX
package's, on the CPU: the twins of `tests/test_batched_orch.py`.

Each twin builds the same seeded inputs through each package's API and
runs the JAX component and the port's on them. Every output here is an
integer or boolean decision, so the tolerance is exact equality. The
census runs on both of the port's CPU branches: numpy below
DIFF_THRESHOLD, and the plain PyTorch version of K18 (the kernel's route
with device="cpu") with the threshold lowered to 1. Thread tests close
every orchestrator, planner and pump in a `finally` and bound every wait;
FakeClock drives the planner where the reference test steps it.
"""
import copy
import importlib
import random
import threading
import time
import types

import numpy as np
import pytest
import torch

JAX_PKG, TORCH_PKG = "swarmkit_tpu", "swarmkit_tpu_torch"


def _api(pkg: str):
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        name=pkg, objects=mod("api.objects"), specs=mod("api.specs"),
        types=mod("api.types"), memory=mod("store.memory"),
        by=mod("store.by"), columnar=mod("store.columnar"),
        batched=mod("orchestrator.batched"),
        replicated=mod("orchestrator.replicated"),
        restart=mod("orchestrator.restart"),
        updater=mod("orchestrator.updater"), base=mod("orchestrator.base"),
        clock=mod("utils.clock"), reconcile=mod("ops.reconcile"))


JAX_API, TORCH_API = _api(JAX_PKG), _api(TORCH_PKG)
APIS = (JAX_API, TORCH_API)
rc = TORCH_API.reconcile


@pytest.fixture(autouse=True)
def _batched_plane_on(monkeypatch):
    # the JAX package's plane has an environment switch; the port's has none
    monkeypatch.delenv("SWARMKIT_TPU_NO_BATCHED_ORCH", raising=False)


# --------------------------------------------------------------- helpers
def _service(api, sid, replicas, image="v1", mode=None, update=None,
             rollback=None, restart=None, version=1):
    sp, t = api.specs, api.types
    svc = api.objects.Service(id=sid)
    svc.spec = sp.ServiceSpec(
        annotations=sp.Annotations(name=sid),
        mode=t.ServiceMode.REPLICATED if mode is None else mode,
        replicas=replicas,
        task=sp.TaskSpec(runtime=sp.ContainerSpec(image=image),
                         restart=restart or sp.RestartPolicy(delay=0.0)))
    if update is not None:
        svc.spec.update = update
    svc.spec.rollback = rollback
    svc.spec_version = api.objects.Version(version)
    return svc


def _task(api, tid, svc, slot, *, desired=None, state=None, node="",
          spec_version=None, image=None):
    sp, ts = api.specs, api.types.TaskState
    t = api.objects.Task(id=tid, service_id=svc.id, slot=slot)
    t.spec = (copy.deepcopy(svc.spec.task) if image is None
              else sp.TaskSpec(runtime=sp.ContainerSpec(image=image),
                               restart=copy.deepcopy(svc.spec.task.restart)))
    t.spec_version = api.objects.Version(
        spec_version if spec_version is not None else svc.spec_version.index)
    t.desired_state = ts.RUNNING if desired is None else desired
    t.status.state = ts.RUNNING if state is None else state
    t.node_id = node
    return t


def _norm(d):
    if d is None:
        return ([], [], [], False)
    return (list(d.create_slots), list(d.victim_slots),
            [[t.id for t in ts] for ts in d.dirty_slots],
            bool(d.kick_update))


def _live(api, view, sid):
    return [t for t in view.find_tasks(api.by.ByServiceID(sid))
            if t.desired_state <= api.types.TaskState.RUNNING]


@pytest.fixture
def census_calls(monkeypatch):
    """Counts the port's census calls by branch: "np" (the numpy mirror)
    and "plain" (K18's plain version, the kernel's route on the CPU)."""
    calls = {"np": 0, "plain": 0}
    for key, name in (("np", "replica_slot_state_np"),
                      ("plain", "replica_slot_state_plain")):
        real = getattr(rc, name)

        def spy(*a, real=real, key=key):
            calls[key] += 1
            return real(*a)
        monkeypatch.setattr(rc, name, spy)
    return calls


def _branch(monkeypatch, branch):
    if branch == "kernel":
        monkeypatch.setattr(rc, "DIFF_THRESHOLD", 1)


# ------------------------------------------------- K18 the slot census
def _census_inputs(rng, S, M, T, p_run=0.6):
    sidx = rng.integers(0, S, T).astype(np.int32)
    slot = rng.integers(0, M, T).astype(np.int32)
    runnable = rng.random(T) < p_run
    running = runnable & (rng.random(T) < 0.6)
    return sidx, slot, runnable, running


def _all_forms_equal(sidx, slot, runnable, running, S, M, monkeypatch):
    """JAX's jit census and numpy mirror against the port's plain version,
    its wrapper on CPU tensors, its numpy mirror and both CPU branches of
    compute_slot_state: every output equal, dtype included."""
    jr = JAX_API.reconcile
    want = [np.asarray(a) for a in
            jr.replica_slot_state(sidx, slot, runnable, running, S, M)]
    forms = {"jax np": jr.replica_slot_state_np(sidx, slot, runnable,
                                                running, S, M)}
    ts = [torch.from_numpy(x) for x in (sidx, slot, runnable, running)]
    forms["plain"] = [a.numpy() for a in
                      rc.replica_slot_state_plain(*ts, S, M)]
    forms["wrapper"] = [a.numpy() for a in rc.replica_slot_state(*ts, S, M)]
    forms["np"] = rc.replica_slot_state_np(sidx, slot, runnable, running, S,
                                           M)
    forms["compute np"] = rc.compute_slot_state(
        sidx.astype(np.int64), slot, runnable, running, S, M, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(rc, "DIFF_THRESHOLD", 1)
        forms["compute kernel route"] = rc.compute_slot_state(
            sidx.astype(np.int64), slot, runnable, running, S, M,
            device="cpu")
    for name, got in forms.items():
        assert len(got) == 4, name
        for w, g in zip(want, got):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    return want


@pytest.mark.parametrize("seed", range(20))
def test_slot_state_parity_fuzz(seed, monkeypatch):
    """`tests/test_batched_orch.py::test_slot_state_kernel_parity_fuzz`'s
    inputs, seed for seed."""
    rng = np.random.default_rng(seed)
    S, M = int(rng.integers(1, 8)), int(rng.integers(1, 10))
    T = int(rng.integers(1, 60))
    _all_forms_equal(*_census_inputs(rng, S, M, T), S, M, monkeypatch)


EDGES = {
    "one cell": (1, 1, lambda r: _census_inputs(r, 1, 1, 5)),
    "no tasks": (3, 4, lambda r: (np.zeros(0, np.int32),
                                  np.zeros(0, np.int32),
                                  np.zeros(0, bool), np.zeros(0, bool))),
    "all on the last key": (5, 7, lambda r: (
        np.full(9, 4, np.int32), np.full(9, 6, np.int32),
        r.random(9) < 0.5, np.zeros(9, bool))),
    "all runnable": (6, 5, lambda r: _census_inputs(r, 6, 5, 40, 1.0)),
    "none runnable": (6, 5, lambda r: _census_inputs(r, 6, 5, 40, 0.0)),
    "one slot a service": (9, 1, lambda r: _census_inputs(r, 9, 1, 30)),
}


@pytest.mark.parametrize("edge", list(EDGES))
def test_slot_state_edges(edge, monkeypatch):
    S, M, make = EDGES[edge]
    out = _all_forms_equal(*make(np.random.default_rng(5)), S, M,
                           monkeypatch)
    if edge == "all on the last key":
        assert out[0].sum() == 1 and out[0][S * M - 1]
        assert out[3].tolist() == [0, 0, 0, 0, int(out[1][-1])]
    if edge == "no tasks":
        assert not any(a.any() for a in out)


def test_slot_state_dispatch(monkeypatch, census_calls):
    """compute_slot_state takes the kernel's route where DIFF_THRESHOLD <=
    S * M < 2^31 and numpy below and from 2^31 on (both limits lowered
    here: a census of 2^31 cells does not fit this machine)."""
    rng = np.random.default_rng(3)
    args = _census_inputs(rng, 4, 5, 30)            # 20 cells
    monkeypatch.setattr(rc, "DIFF_THRESHOLD", 21)
    rc.compute_slot_state(*args, 4, 5, device="cpu")
    assert census_calls == {"np": 1, "plain": 0}
    monkeypatch.setattr(rc, "DIFF_THRESHOLD", 20)
    rc.compute_slot_state(*args, 4, 5, device="cpu")
    assert census_calls == {"np": 1, "plain": 1}
    monkeypatch.setattr(rc, "_I32", 20)             # 20 cells "wrap" now
    rc.compute_slot_state(*args, 4, 5, device="cpu")
    assert census_calls == {"np": 2, "plain": 1}


def test_slot_state_refuses_bad_input(monkeypatch):
    """Out-of-range indices, wrong dtypes and ranks, a census of 2^31 cells
    and a device without a kernel raise ValueError; the reference's numpy
    mirror raises IndexError on a key past the planes."""
    rng = np.random.default_rng(1)
    sidx, slot, runnable, running = _census_inputs(rng, 4, 5, 30)
    ts = [torch.from_numpy(x) for x in (sidx, slot, runnable, running)]
    bad = {"service": (sidx + 4, slot), "negative service": (sidx - 5, slot),
           "slot": (sidx, slot + 5), "negative slot": (sidx, slot - 5)}
    for name, (s, m) in bad.items():
        with pytest.raises(ValueError, match="outside"):
            rc.replica_slot_state(torch.from_numpy(s), torch.from_numpy(m),
                                  *ts[2:], 4, 5)
        for branch in ("numpy", "kernel"):
            with monkeypatch.context() as mp:
                _branch(mp, branch)
                with pytest.raises(ValueError, match="outside"):
                    rc.compute_slot_state(s, m, runnable, running, 4, 5,
                                          device="cpu")
    with pytest.raises(IndexError):
        JAX_API.reconcile.replica_slot_state_np(sidx + 4, slot, runnable,
                                                running, 4, 5)
    # an int64 index past 2^32 is refused, not cut to int32 first
    with pytest.raises(ValueError, match="outside"):
        rc.compute_slot_state(sidx.astype(np.int64) + (1 << 32), slot,
                              runnable, running, 4, 5, device="cpu")
    wrong = [(ts[0].long(), *ts[1:]), (ts[0], ts[1].short(), *ts[2:]),
             (*ts[:2], ts[2].int(), ts[3]), (ts[0][None], *ts[1:]),
             (ts[0], ts[1][:-1], *ts[2:])]
    for args in wrong:
        with pytest.raises(ValueError, match="expected a 1-D"):
            rc.replica_slot_state(*args, 4, 5)
    with pytest.raises(ValueError, match="2\\^31"):
        rc.replica_slot_state(*ts, 1 << 16, 1 << 15)
    with pytest.raises(ValueError, match="meta"):
        rc.replica_slot_state(*(t.to("meta") for t in ts), 4, 5)
    with pytest.raises(ValueError):
        rc.replica_slot_state(ts[0].to("meta"), *ts[1:], 4, 5)


# ------------------------------------------------------ reconcile parity
def _seed_cluster(api, store, rng, n_services=10):
    """`tests/test_batched_orch.py::_seed_cluster`, through `api`."""
    ts = api.types.TaskState
    ids, objs = [], []
    for s in range(n_services):
        sid = f"svc{s:03d}"
        ids.append(sid)
        svc = _service(api, sid, replicas=rng.randrange(0, 7),
                       version=rng.randrange(1, 4))
        objs.append(svc)
        n_slots = rng.randrange(0, 9)
        for slot in range(1, n_slots + 1):
            if rng.random() < 0.15:
                continue            # a hole in the slot sequence
            for dup in range(1 + (rng.random() < 0.25)):
                sv = rng.randrange(1, 4)
                img = "v1" if rng.random() < 0.5 else f"v{sv}"
                objs.append(_task(
                    api, f"t-{sid}-{slot}-{dup}", svc, slot,
                    desired=rng.choice([ts.RUNNING, ts.READY, ts.SHUTDOWN,
                                        ts.REMOVE]),
                    state=rng.choice([ts.NEW, ts.PENDING, ts.RUNNING,
                                      ts.FAILED, ts.COMPLETE]),
                    node=rng.choice(["", "n1", "n2", "n3", "n4"]),
                    spec_version=sv, image=img))

    def cb(tx):
        for obj in objs:
            tx.create(obj)

    store.update(cb)
    return ids


def _reconciler(api, store):
    kw = {"device": "cpu"} if api is TORCH_API else {}
    return api.batched.BatchedReconciler(store, **kw)


@pytest.mark.parametrize("branch", ["numpy", "kernel"])
@pytest.mark.parametrize("seed", range(25))
def test_reconcile_decision_parity_fuzz(seed, branch, monkeypatch,
                                        census_calls):
    """decide_many of both packages and decide_service of both, service for
    service: create fills, victim order, dirty slots and the kick."""
    _branch(monkeypatch, branch)
    out = {}
    for api in APIS:
        store = api.memory.MemoryStore()
        ids = _seed_cluster(api, store, random.Random(seed))
        view = store.view()
        got = _reconciler(api, store).decide_many(ids, view=view)
        out[api.name] = {sid: _norm(got.get(sid)) for sid in ids}
        out[api.name + " scalar"] = {
            sid: _norm(api.replicated.decide_service(
                view.get_service(sid), _live(api, view, sid)))
            for sid in ids}
    want = out[JAX_PKG + " scalar"]
    for name, got in out.items():
        assert got == want, (seed, name)
    assert census_calls["plain" if branch == "kernel" else "np"] == 1


def test_reconcile_skips_non_replicated_and_pending_delete():
    for api in APIS:
        store = api.memory.MemoryStore()

        def cb(tx):
            tx.create(_service(api, "glob", 3,
                               mode=api.types.ServiceMode.GLOBAL))
            gone = _service(api, "gone", 3)
            gone.pending_delete = True
            tx.create(gone)
            tx.create(_service(api, "live", 2))

        store.update(cb)
        got = _reconciler(api, store).decide_many(
            ["glob", "gone", "live", "never-created"])
        assert set(got) == {"live"}, api.name
        assert got["live"].create_slots == [1, 2], api.name


@pytest.mark.parametrize("branch", ["numpy", "kernel"])
def test_reconcile_steady_pass_is_objectless(branch, monkeypatch,
                                             census_calls):
    """A converged pass classifies every service with zero object reads
    and zero store transactions (op counts), in both packages."""
    _branch(monkeypatch, branch)
    stats = {}
    for api in APIS:
        store = api.memory.MemoryStore()

        def cb(tx):
            for s in range(40):
                svc = _service(api, f"s{s}", 3)
                tx.create(svc)
                for slot in (1, 2, 3):
                    tx.create(_task(api, f"t{s}-{slot}", svc, slot))

        store.update(cb)
        br = _reconciler(api, store)
        tx0 = store.op_counts["update_tx"]
        assert br.decide_many([f"s{s}" for s in range(40)]) == {}
        assert store.op_counts["update_tx"] == tx0
        stats[api.name] = dict(br.stats)
    assert stats[TORCH_PKG] == stats[JAX_PKG]
    assert stats[TORCH_PKG]["services_steady"] == 40
    assert stats[TORCH_PKG].get("object_reads", 0) == 0
    assert census_calls["plain" if branch == "kernel" else "np"] == 1


def test_reconcile_oversized_slot_falls_back_scalar():
    got = {}
    for api in APIS:
        store = api.memory.MemoryStore()

        def cb(tx):
            svc = _service(api, "big", 2)
            tx.create(svc)
            tx.create(_task(api, "t-big", svc, 1_000_000))
            tx.create(_task(api, "t-neg", svc, -3))

        store.update(cb)
        br = _reconciler(api, store)
        d = br.decide_many(["big"])
        assert br.stats["scalar_fallbacks"] >= 1, api.name
        view = store.view()
        want = api.replicated.decide_service(view.get_service("big"),
                                             _live(api, view, "big"))
        assert _norm(d.get("big")) == _norm(want), api.name
        got[api.name] = _norm(d.get("big"))
    assert got[TORCH_PKG] == got[JAX_PKG]


def test_shared_primitives():
    summaries = {1: (True, ["a", "a"]), 2: (True, ["a"]), 3: (False, ["b"]),
                 4: (True, ["b"])}
    rng = random.Random(11)
    for api in APIS:
        b = api.batched
        assert b.fill_slots({2, 4}, 3) == [1, 3, 5]
        assert b.fill_slots(set(), 0) == []
        assert b.victim_order(dict(summaries), 3) == [3, 2, 1]
    for _ in range(200):
        used = set(rng.sample(range(1, 30), rng.randrange(0, 12)))
        k = rng.randrange(0, 8)
        summ = {s: (rng.random() < 0.5,
                    [rng.choice("abcd") for _ in range(rng.randrange(0, 3))])
                for s in rng.sample(range(1, 20), rng.randrange(0, 10))}
        excess = rng.randrange(0, 12)
        assert TORCH_API.batched.fill_slots(used, k) == \
            JAX_API.batched.fill_slots(used, k)
        assert TORCH_API.batched.victim_order(dict(summ), excess) == \
            JAX_API.batched.victim_order(dict(summ), excess)


def test_plane_is_always_on():
    """The port has no environment switch and no second path: its store
    always keeps the columnar mirror, and the orchestrator always builds
    the batched reconciler on its device and the wave planner."""
    store = TORCH_API.memory.MemoryStore()
    assert store.columnar is not None
    orch = TORCH_API.replicated.ReplicatedOrchestrator(store, device="cpu")
    try:
        assert orch.batched is not None and orch.batched.device == "cpu"
        assert orch.updater.planner is not None
    finally:
        orch.stop()


# ---------------------------------------------------- restart gate parity
def _restart_fixture(api, rng, clock):
    """`tests/test_batched_orch.py::_restart_fixture`, through `api`."""
    t, r = api.types, api.restart
    sup = r.RestartSupervisor(api.memory.MemoryStore(), clock=clock)
    services = []
    for i in range(4):
        cond = rng.choice(list(t.RestartCondition))
        services.append(_service(
            api, f"rs{i}", 3,
            restart=api.specs.RestartPolicy(
                condition=cond, delay=0.0,
                max_attempts=rng.choice([0, 1, 2, 3]),
                window=rng.choice([0.0, 5.0, 30.0])),
            mode=rng.choice([t.ServiceMode.REPLICATED,
                             t.ServiceMode.REPLICATED_JOB])))
    pairs = []
    for j in range(rng.randrange(1, 14)):
        svc = rng.choice(services)
        slot = rng.randrange(0, 3)      # duplicate keys on purpose
        pairs.append((svc, _task(
            api, f"dead{j}", svc, slot,
            state=rng.choice([t.TaskState.FAILED, t.TaskState.COMPLETE,
                              t.TaskState.REJECTED, t.TaskState.SHUTDOWN]),
            node=rng.choice(["", "nA", "nB"]))))
    now = clock.time()
    for svc in services:
        for slot in range(3):
            if rng.random() < 0.5:
                info = r.InstanceRestartInfo(
                    total_restarts=rng.randrange(0, 4))
                info.restarted_instances = [
                    r.RestartedInstance(now - rng.uniform(0.0, 40.0))
                    for _ in range(rng.randrange(0, 4))]
                sup._history[(svc.id, slot if slot else "")] = info
    return sup, pairs


def _strip(history):
    return {k: (v.total_restarts,
                [x.timestamp for x in v.restarted_instances])
            for k, v in history.items()}


@pytest.mark.parametrize("seed", range(22))
def test_restart_gate_parity_fuzz(seed):
    """batch_should_restart of both packages against the port's sequential
    should_restart calls with interleaved records: the same grants, then
    (once the caller records the grants) the same histories, window prune
    included."""
    grants, histories = {}, {}
    for api in APIS:
        clock = api.clock.FakeClock(start=10_000.0)
        sup, pairs = _restart_fixture(api, random.Random(1000 + seed), clock)
        if api is TORCH_API:
            oracle = api.restart.RestartSupervisor(api.memory.MemoryStore(),
                                                   clock=clock)
            oracle._history = copy.deepcopy(sup._history)
            want = []
            for svc, t in pairs:
                want.append(oracle.should_restart(t, svc))
                if want[-1]:
                    oracle._record(t, svc)
        got = api.batched.batch_should_restart(sup, pairs)
        for (svc, t), g in zip(pairs, got):
            if g:
                sup._record(t, svc)
        grants[api.name] = got.tolist()
        histories[api.name] = _strip(sup._history)
        sup.stop()
    assert grants[TORCH_PKG] == want == grants[JAX_PKG], seed
    assert histories[TORCH_PKG] == _strip(oracle._history) \
        == histories[JAX_PKG], seed
    oracle.stop()


def _restart_census(api, batched: bool):
    """`test_restart_many_matches_sequential_restarts`'s store: four FAILED
    tasks on a down node under max_attempts=2 in a 10 s window, restarted
    in one restart_many (batched) or by sequential restart() calls."""
    clock = api.clock.FakeClock(start=500.0)
    store = api.memory.MemoryStore()
    svc = _service(api, "svc", 4, restart=api.specs.RestartPolicy(
        delay=0.0, max_attempts=2, window=10.0))
    tasks = [_task(api, f"d{i}", svc, i + 1,
                   state=api.types.TaskState.FAILED, node="down-node")
             for i in range(4)]

    def cb(tx):
        tx.create(svc)
        for t in tasks:
            tx.create(t)

    store.update(cb)
    sup = api.restart.RestartSupervisor(store, clock=clock)
    if batched:
        store.update(lambda tx: sup.restart_many(
            tx, None, [(svc, t) for t in tasks]))
    else:
        def seq(tx):
            for t in tasks:
                sup.restart(tx, None, svc, t)
        store.update(seq)
    census = {}
    for t in store.view(lambda tx: tx.find_tasks()):
        key = (t.slot, int(t.desired_state), int(t.status.state))
        census[key] = census.get(key, 0) + 1
    out = (census, {k: v.total_restarts for k, v in sup._history.items()},
           sorted(sup._delays))
    sup.stop()
    return out


def test_restart_many_matches_sequential_restarts():
    """restart_many's store effects equal N sequential restart() calls
    (shutdown marks, replacement slots, history), and the JAX package's
    restart_many's."""
    port_many = _restart_census(TORCH_API, True)
    port_seq = _restart_census(TORCH_API, False)
    jax_many = _restart_census(JAX_API, True)
    assert port_many[:2] == port_seq[:2] == jax_many[:2]
    assert len(port_many[2]) == len(port_seq[2]) == 4


def test_restart_many_mixed_batch_matches_sequential():
    """A seeded batch with duplicate keys and every restart condition:
    restart_many grants and records what sequential restart() grants."""
    for seed in range(6):
        out = {}
        for mode in ("many", "seq"):
            clock = TORCH_API.clock.FakeClock(start=10_000.0)
            sup, pairs = _restart_fixture(TORCH_API, random.Random(seed),
                                          clock)
            store = TORCH_API.memory.MemoryStore()
            sup.store = store

            def cb(tx, pairs=pairs):
                for svc in {s.id: s for s, _ in pairs}.values():
                    tx.create(svc)
                for _, t in pairs:
                    if tx.get_task(t.id) is None:
                        tx.create(t)

            store.update(cb)
            if mode == "many":
                store.update(lambda tx: sup.restart_many(tx, None, pairs))
            else:
                store.update(lambda tx: [sup.restart(tx, None, s, t)
                                         for s, t in pairs])
            tasks = store.view(lambda tx: tx.find_tasks())
            out[mode] = (sorted((t.service_id, t.slot, int(t.desired_state))
                                for t in tasks), _strip(sup._history))
            sup.stop()
        assert out["many"] == out["seq"], seed


# ------------------------------------------------------- FakeClock pins
def _stepped_planner(api, store):
    fc = api.clock.FakeClock(start=100.0)
    restart = api.restart.RestartSupervisor(store, clock=fc)
    return fc, api.batched.UpdateWavePlanner(store, restart, clock=fc)


def _push_v2(api, store, sid="svc", image="v2"):
    cur = store.view(lambda tx: tx.get_service(sid))
    new = cur.copy()
    new.previous_spec = copy.deepcopy(cur.spec)
    new.spec = copy.deepcopy(cur.spec)
    new.spec.task.runtime.image = image
    new.spec_version = api.objects.Version(cur.spec_version.index + 1)
    store.update(lambda tx: tx.update(new))


def _mk_update_target(api, store, *, monitor=10.0, delay=0.0,
                      parallelism=1):
    t = api.types
    svc = _service(api, "svc", 2, update=api.specs.UpdateConfig(
        parallelism=parallelism, delay=delay, monitor=monitor,
        order=t.UpdateOrder.STOP_FIRST,
        failure_action=t.UpdateFailureAction.PAUSE, max_failure_ratio=0.0))

    def cb(tx):
        tx.create(svc)
        for slot in (1, 2):
            tx.create(_task(api, f"t{slot}", svc, slot))

    store.update(cb)
    _push_v2(api, store)


def _observe_stops(api, store):
    ts = api.types.TaskState

    def cb(tx):
        for t in tx.find_tasks():
            if t.desired_state >= ts.SHUTDOWN and t.status.state <= ts.RUNNING:
                c = t.copy()
                c.status.state = ts.SHUTDOWN
                tx.update(c)

    store.update(cb)


def _start_replacements(api, store, state=None):
    ts = api.types.TaskState
    started = []

    def cb(tx):
        for t in tx.find_tasks():
            if t.desired_state == ts.RUNNING and t.status.state < ts.RUNNING \
                    and t.spec.runtime.image == "v2":
                c = t.copy()
                c.status.state = ts.RUNNING if state is None else state
                tx.update(c)
                started.append(c.id)

    store.update(cb)
    return started


def _final_state(store, sid="svc"):
    svc = store.view(lambda tx: tx.get_service(sid))
    return (svc.update_status or {}).get("state")


def _monitor_edge(api, fail_at):
    """`test_fakeclock_monitor_window_edge` for one offset: the final update
    status and the planner's counters at the end."""
    store = api.memory.MemoryStore()
    fc, pl = _stepped_planner(api, store)
    _mk_update_target(api, store, monitor=10.0)
    st = api.batched._ServiceUpdate("svc")
    pl._states["svc"] = st
    pl._step(st)                      # init -> rolling: slot 1 flips
    assert len(st.in_flight) == 1
    _observe_stops(api, store)
    pl._step(st)                      # old stopped -> promote slot 1
    new_ids = _start_replacements(api, store)
    pl._step(st)                      # flip lands; monitor opens
    for _ in range(6):
        fc.advance(0.05)
        _observe_stops(api, store)
        _start_replacements(api, store)
        pl._step(st)
        if not st.in_flight and not st.pending:
            break
    assert st.monitored, "monitor windows must be open"
    first = new_ids[0]
    target = dict(st.monitored)[first] - 10.0 + fail_at
    fc.advance(target - fc.monotonic())
    if fail_at > 10.0:
        pl._step(st)                  # the poll that expires the window
        assert first not in st.monitored

    def fail_first(tx):
        c = tx.get_task(first).copy()
        c.status.state = api.types.TaskState.FAILED
        tx.update(c)

    store.update(fail_first)
    for _ in range(300):
        pl._step(st)
        if st.done:
            break
        fc.advance(0.1)
    assert st.done
    pl.stop()
    return _final_state(store), st.updated, len(st.failed), st.aborted


@pytest.mark.parametrize("fail_at,expect", [(9.9, "paused"),
                                            (10.2, "completed")])
def test_fakeclock_monitor_window_edge(fail_at, expect):
    """A replacement failing inside its monitor window counts (pause); one
    failing after the window expired does not (completed). Stepped
    directly, no planner thread; the port's outcome equals the JAX
    package's."""
    got = _monitor_edge(TORCH_API, fail_at)
    assert got[0] == expect
    assert got == _monitor_edge(JAX_API, fail_at)


def _delay_trace(api):
    """`test_fakeclock_delay_paces_flips`: the in-flight slots at each
    checkpoint and the final status."""
    store = api.memory.MemoryStore()
    fc, pl = _stepped_planner(api, store)
    _mk_update_target(api, store, monitor=0.0, delay=5.0)
    st = api.batched._ServiceUpdate("svc")
    pl._states["svc"] = st
    trace = []
    pl._step(st)                          # flip slot 1
    trace.append(sorted(st.in_flight))
    _observe_stops(api, store)
    pl._step(st)                          # slot 1 promotes; cooldown opens
    _start_replacements(api, store)
    trace.append((sorted(st.in_flight), len(st.cooldowns)))
    fc.advance(4.9)
    pl._step(st)
    trace.append(sorted(st.in_flight))    # still inside the cooldown
    fc.advance(0.2)                       # past the 5 s edge
    pl._step(st)
    trace.append(sorted(st.in_flight))
    _observe_stops(api, store)
    pl._step(st)
    _start_replacements(api, store)
    for _ in range(200):
        pl._step(st)
        if st.done:
            break
        fc.advance(0.2)
    trace.append((st.done, _final_state(store)))
    pl.stop()
    return trace


def test_fakeclock_delay_paces_flips():
    """delay=5 with parallelism=1: the second slot's flip starts only
    after the cooldown, at the edge; the same trace as the JAX
    package's."""
    got = _delay_trace(TORCH_API)
    assert got == [[1], ([], 1), [], [2], (True, "completed")]
    assert got == _delay_trace(JAX_API)


def test_planner_supersede_and_pause_gates():
    """update() on a live pass is a no-op; a PAUSED service never starts a
    pass. Both packages."""
    for api in APIS:
        store = api.memory.MemoryStore()
        fc, pl = _stepped_planner(api, store)
        _mk_update_target(api, store)
        st = api.batched._ServiceUpdate("svc")
        pl._states["svc"] = st
        pl.update(store.view(lambda tx: tx.get_service("svc")), [])
        assert pl._states["svc"] is st, api.name
        store2 = api.memory.MemoryStore()
        fc2, pl2 = _stepped_planner(api, store2)
        _mk_update_target(api, store2)

        def pause(tx):
            cur = tx.get_service("svc").copy()
            cur.update_status = {"state": "paused", "message": "x",
                                 "timestamp": 0.0}
            tx.update(cur)

        store2.update(pause)
        st2 = api.batched._ServiceUpdate("svc")
        pl2._states["svc"] = st2
        try:
            pl2._step(st2)
            assert st2.done and _final_state(store2) == "paused", api.name
        finally:
            pl.stop()
            pl2.stop()


# ------------------------------------------------ threads: orchestrators
class _Pump(threading.Thread):
    """Deterministic fake agent: tasks desired RUNNING start (or FAIL, per
    the fail predicate); shutdowns are observed stopped."""

    def __init__(self, api, store, fails=lambda t: False):
        super().__init__(daemon=True, name="orch-pump")
        self.api, self.store, self.fails = api, store, fails
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
                        c.status.state = (ts.FAILED if self.fails(t)
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


def _wait(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _running(api, store, image=None):
    ts = api.types.TaskState
    out = [t for t in store.view(lambda tx: tx.find_tasks())
           if t.status.state == ts.RUNNING and t.desired_state <= ts.RUNNING]
    if image is not None:
        out = [t for t in out if t.spec.runtime.image == image]
    return out


def _orchestrator(api, store):
    kw = {"device": "cpu"} if api is TORCH_API else {}
    return api.replicated.ReplicatedOrchestrator(store, **kw)


def _planner_outcome(api, threaded, replicas, order, action, will_fail):
    """`test_planner_matches_threaded_updater_outcomes` for one run: the
    port's planner, the port's threaded Updater (threaded=True: the
    supervisor's planner taken away before any update) or the JAX
    package's planner."""
    t = api.types

    def fails(task):
        return will_fail and task.spec.runtime.image == "v2"

    store = api.memory.MemoryStore()
    orch = _orchestrator(api, store)
    if threaded:
        orch.updater.planner = None
    pump = _Pump(api, store, fails=fails)
    try:
        orch.start()
        pump.start()
        svc = _service(api, "svc", replicas, update=api.specs.UpdateConfig(
            parallelism=1, delay=0.0, monitor=0.4, order=order,
            failure_action=action, max_failure_ratio=0.0))
        store.update(lambda tx: tx.create(svc))
        assert _wait(lambda: len(_running(api, store, "v1")) == replicas)
        _push_v2(api, store)
        if not will_fail:
            assert _wait(lambda: len(_running(api, store, "v2")) == replicas
                         and _final_state(store) == "completed")
        elif action == t.UpdateFailureAction.ROLLBACK:
            assert _wait(lambda: _final_state(store) == "rollback_completed")
            assert _wait(lambda: len(_running(api, store, "v1")) >= replicas)
        else:
            assert _wait(lambda: _final_state(store) == "paused")
        tasks = store.view(lambda tx: tx.find_tasks())
        return (_final_state(store),
                store.view(lambda tx: tx.get_service(
                    "svc")).spec.task.runtime.image,
                tuple(sorted({x.slot for x in tasks
                              if x.spec.runtime.image == "v2"
                              and x.desired_state <= t.TaskState.RUNNING}))
                if not will_fail else None)
    finally:
        pump.stop()
        orch.stop()


@pytest.mark.parametrize("seed", range(4))
def test_planner_matches_threaded_updater_outcomes(seed):
    """Converged outcomes per seed: the port's planner against the port's
    threaded Updater and against the JAX package's planner (the same
    flipped slots, terminal status and rollback), under a seeded failure
    schedule; parallelism=1 keeps the decisions serial."""
    rng = random.Random(40 + seed)
    replicas = rng.randrange(2, 5)
    order_i = rng.randrange(2)
    action_i = rng.randrange(3)
    will_fail = rng.random() < 0.4
    if will_fail:
        # CONTINUE with an always-failing start-first image never ends, by
        # design, in every implementation
        action_i = rng.choice([0, 1])
    outcomes = {}
    for name, api, threaded in (("port planner", TORCH_API, False),
                                ("port updater", TORCH_API, True),
                                ("jax planner", JAX_API, False)):
        t = api.types
        order = [t.UpdateOrder.STOP_FIRST, t.UpdateOrder.START_FIRST][order_i]
        action = [t.UpdateFailureAction.ROLLBACK, t.UpdateFailureAction.PAUSE,
                  t.UpdateFailureAction.CONTINUE][action_i]
        outcomes[name] = _planner_outcome(api, threaded, replicas, order,
                                          action, will_fail)
    assert len(set(outcomes.values())) == 1, (seed, outcomes)


def _lockstep(api):
    store = api.memory.MemoryStore()
    orch = _orchestrator(api, store)
    pump = _Pump(api, store)
    try:
        orch.start()
        pump.start()
        svc = _service(api, "svc", 3, update=api.specs.UpdateConfig(
            parallelism=2, delay=0.0, monitor=0.1))
        store.update(lambda tx: tx.create(svc))
        assert _wait(lambda: len(_running(api, store, "v1")) == 3)
        _push_v2(api, store)
        assert _wait(lambda: len(_running(api, store, "v2")) == 3
                     and _final_state(store) == "completed")
    finally:
        pump.stop()
        orch.stop()
    tasks = store.view(lambda tx: tx.find_tasks())
    services = store.view(lambda tx: tx.find_services())
    rebuilt = api.columnar.ColumnarTasks.rebuild(tasks, services=services)
    assert api.columnar.ColumnarTasks.snapshots_equal(
        store.columnar.snapshot(), rebuilt.snapshot()), api.name
    scol = store.columnar.service_cols
    row = scol.row_of("svc")
    assert row > 0 and scol.replicas[row] == 3 \
        and scol.spec_version[row] == services[0].spec_version.index
    ts = api.types.TaskState
    return sorted((x.slot, x.spec.runtime.image) for x in tasks
                  if x.desired_state <= ts.RUNNING)


def test_columnar_mirror_stays_lockstep_through_orchestration():
    """After a reconcile and a rolling update on the live loop, the task
    columns and the service hot columns equal a rebuild from the objects;
    the live slots equal the JAX package's."""
    got = _lockstep(TORCH_API)
    assert got == [(1, "v2"), (2, "v2"), (3, "v2")]
    assert got == _lockstep(JAX_API)


def _kick(api):
    store = api.memory.MemoryStore()
    svc = _service(api, "svc", 2, image="v1", version=3)
    svc.update_status = {"state": "rollback_started", "message": "x",
                         "timestamp": 0.0}

    def cb(tx):
        tx.create(svc)
        for slot in (1, 2):
            tx.create(_task(api, f"t{slot}", svc, slot, spec_version=3))

    store.update(cb)
    view = store.view()
    want = api.replicated.decide_service(svc, _live(api, view, "svc"))
    assert want.kick_update and not want.dirty_slots
    got = _reconciler(api, store).decide_many(["svc"], view=view)
    assert _norm(got.get("svc")) == _norm(want)
    orch = _orchestrator(api, store)
    try:
        orch.start()
        orch.reconcile_many(["svc"])
        assert _wait(lambda: _final_state(store) == "rollback_completed")
    finally:
        orch.stop()
    return _norm(got.get("svc")), _final_state(store)


def test_kick_completes_restart_converged_rollback():
    """A ROLLBACK_STARTED service with no dirty slot left gets a no-op
    update pass that writes ROLLBACK_COMPLETED: both deciders emit the
    kick and the orchestrator feeds the planner on it, in both
    packages."""
    assert _kick(TORCH_API) == _kick(JAX_API)


def _drain(api):
    class Counter(api.base.EventLoopComponent):
        name = "drain-counter"

        def __init__(self, store):
            super().__init__(store)
            self.seen = set()
            self.flushes = 0

        def handle(self, event):
            if isinstance(event, api.objects.EventCreate) \
                    and isinstance(event.obj, api.objects.Task):
                self.seen.add(event.obj.id)

        def flush_events(self):
            self.flushes += 1

    store = api.memory.MemoryStore()
    comp = Counter(store)
    try:
        comp.start()
        n = comp.MAX_DRAIN * 2 + 50

        def cb(batch):
            for i in range(n):
                batch.update(lambda tx, i=i: tx.create(api.objects.Task(
                    id=f"burst-{i:04d}", service_id="s", slot=i)))

        store.batch(cb)
        assert _wait(lambda: len(comp.seen) == n), \
            f"dropped {n - len(comp.seen)} events"
        assert comp.flushes >= 1
        return len(comp.seen)
    finally:
        comp.stop()


def test_event_drain_loses_nothing_over_max_drain():
    """A burst longer than MAX_DRAIN reaches handle() event for event and
    flush_events runs after each burst, in both packages."""
    assert _drain(TORCH_API) == _drain(JAX_API)
