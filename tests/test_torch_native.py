"""The port's native host loops (`swarmkit_tpu_torch/native`): build, load,
and equality with the pure-Python walk and with the JAX package's walk.

The C commit walk must leave every NodeInfo exactly as the port's Python
walk leaves it (the oracle, itself equal to per-task add_task) and as the
JAX package's walk leaves the same cluster built in that package: same
end state, same return value, across plain cells, collisions (the
double-commit heal), removed nodes, and the per-task port/generic groups.
`tree_copy` must equal `copy.deepcopy` on every table of the object model.
After the JAX package's tests/test_native_hostops.py.
"""
import copy
import dataclasses
import random
import threading

import numpy as np
import pytest
import torch

from swarmkit_tpu_torch import native
from swarmkit_tpu_torch.scheduler import batch as torch_batch
from swarmkit_tpu_torch.utils import failpoints
from test_torch_resident import SIDES, make_info, make_task

torch.set_num_threads(1)


def info_state(info) -> tuple:
    """Everything the walk writes on a NodeInfo, comparable across the
    two packages."""
    ar = info.available_resources
    return (info.mutations, info.active_tasks_count,
            dict(info.active_tasks_count_by_service), ar.nano_cpus,
            ar.memory_bytes, dict(ar.generic),
            {k: set(v) for k, v in ar.named_generic.items()},
            sorted(info.used_host_ports), sorted(info.tasks),
            repr(info.generic_assignments))


def assert_infos_equal(a, b, what=""):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert (x is None) == (y is None), f"{what} node {i}"
        if x is not None:
            assert info_state(x) == info_state(y), f"{what} node {i}"


def test_native_module_builds_into_build_and_loads():
    """The toolchain here builds the extension: a silent fallback to the
    Python walk would hide the path the card measures."""
    mod = native.load()
    assert mod is not None, "native _hostops failed to build"
    assert native.LIB.parent.name == "native"
    assert native.LIB.parent.parent.name == "build"
    assert native.LIB.exists() and mod.__file__ == str(native.LIB)
    for fn in ("apply_wave", "apply_segments", "tree_copy"):
        assert hasattr(mod, fn)
    assert not (native.SRC.parent / native.LIB.name).exists()


def test_concurrent_builds_race_safely(tmp_path, monkeypatch):
    """Two builds at once each compile to their own temporary file and
    rename it into place: both succeed, no temporary file is left, and
    the library in place is whole."""
    lib = tmp_path / native.LIB.name
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "LIB", lib)
    ok = []
    threads = [threading.Thread(target=lambda: ok.append(native.build()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert ok == [True, True]
    assert [p.name for p in tmp_path.iterdir()] == [lib.name]
    assert lib.read_bytes()[:4] == b"\x7fELF"


def make_wave(api, rng, n_nodes, wave, seed, per_task=False):
    """One wave's placed groups (t0, tasks, node_idx) from `rng`; with
    per_task, one group publishes a host port and one claims a generic
    resource (the per-task add_task groups)."""
    placed = []
    for gi in range(rng.randint(1, 4)):
        svc = f"svc-{rng.randrange(3):03d}"
        tasks = [make_task(api, rng, svc, seed * 10000 + wave * 1000
                           + gi * 100 + i)
                 for i in range(rng.randint(1, 10))]
        shared = tasks[0].spec
        if per_task and gi == 0:
            for t in tasks:
                t.endpoint = api.specs.EndpointSpec(ports=[
                    api.specs.PortConfig(protocol="tcp", target_port=80,
                                         published_port=9000 + wave,
                                         publish_mode="host")])
        if per_task and gi == 1:
            shared.resources.reservations.generic = {"gpu": 1}
        for t in tasks:
            t.spec = shared
            t.service_id = svc
        order = np.array([rng.randrange(n_nodes) for _ in tasks], np.int64)
        placed.append((tasks[0], tasks, order))
    return placed


def walk_trace(side, seed, native_walk, n_nodes=6, waves=4):
    """Waves (some repeated: the all-collision heal) through one side's
    apply_placements; returns the infos and the counts added."""
    api, _mod, batch = SIDES[side]
    rng_i = random.Random(seed)
    infos = [make_info(api, rng_i, i) for i in range(n_nodes)]
    for k, info in enumerate(infos):
        if k % 2 == 0:
            info.available_resources.generic = {"gpu": 4}
    if seed % 2:
        infos[2] = None
    rng = random.Random(500 + seed)
    added = []
    for wave in range(waves):
        placed = make_wave(api, rng, n_nodes, wave, seed,
                           per_task=seed % 3 == 0)
        for _ in range(2 if rng.random() < 0.4 else 1):
            if side == "jax":
                added.append(batch.apply_placements(infos, placed))
            else:
                added.append(batch.apply_placements(
                    infos, placed, native_walk=native_walk))
    return infos, added


@pytest.mark.parametrize("seed", range(6))
def test_native_walk_matches_python_walk_and_jax(seed):
    nat, n_nat = walk_trace("torch", seed, True)
    py, n_py = walk_trace("torch", seed, False)
    ref, n_ref = walk_trace("jax", seed, True)
    assert n_nat == n_py == n_ref
    assert_infos_equal(nat, py, "native vs python")
    assert_infos_equal(nat, ref, "port vs jax")


def _dup_wave(api):
    """A wave that repeats one task id within a single node's segment."""
    rng = random.Random(7)
    tasks = [make_task(api, rng, "svc-dup", i) for i in range(6)]
    for t in tasks:
        t.spec = tasks[0].spec
        t.service_id = "svc-dup"
    tasks[4] = tasks[1]                      # the same id twice in the wave
    return [(tasks[0], tasks, np.zeros(len(tasks), np.int64))], tasks


@pytest.mark.parametrize("native_walk", [False, True])
def test_duplicate_id_within_wave_heals_to_oracle(native_walk):
    """A task id repeated inside one wave counts once, as serial add_task
    counts it, in both walks."""
    api = SIDES["torch"][0]
    info_bulk = [make_info(api, random.Random(1), 0)]
    info_oracle = [make_info(api, random.Random(1), 0)]
    placed, tasks = _dup_wave(api)
    n_bulk = torch_batch.apply_placements(info_bulk, placed,
                                          native_walk=native_walk)
    n_oracle = sum(1 for t in tasks if info_oracle[0].add_task(t))
    assert n_bulk == n_oracle == len(tasks) - 1
    assert_infos_equal(info_bulk, info_oracle)


@pytest.mark.parametrize("native_walk", [False, True])
def test_commit_walk_failpoint_leaves_nothing_half_applied(native_walk):
    """`commit.walk` fires before any NodeInfo mutates: the wave raises,
    every info is untouched, and the same wave applies cleanly after."""
    api = SIDES["torch"][0]
    infos = [make_info(api, random.Random(3), i) for i in range(6)]
    before = [info_state(i) for i in infos]
    placed = make_wave(api, random.Random(4), 6, 0, 3, per_task=True)
    try:
        with failpoints.armed("commit.walk", error=RuntimeError) as fp:
            with pytest.raises(RuntimeError, match="injected"):
                torch_batch.apply_placements(infos, placed,
                                             native_walk=native_walk)
            assert fp.fired == 1
    finally:
        failpoints.disarm_all()
    assert [info_state(i) for i in infos] == before
    n = torch_batch.apply_placements(infos, placed, native_walk=native_walk)
    oracle = [make_info(api, random.Random(3), i) for i in range(6)]
    assert n == sum(oracle[ni].add_task(t) for _t0, ts, order in placed
                    for t, ni in zip(ts, order.tolist()))
    assert_infos_equal(infos, oracle)


def test_native_walk_reentrant_across_threads():
    """The async commit plane runs the C walk on a worker thread while the
    wave loop runs Python, and the walk yields the GIL between segments:
    two walks on DISJOINT info sets in parallel threads end as a serial
    run of the same waves does."""
    api = SIDES["torch"][0]

    def mk_wave(rng, n_nodes, tag):
        placed = []
        for gi in range(12):
            svc = f"svc-{tag}-{gi:03d}"
            tasks = [make_task(api, rng, svc, gi * 1000 + i)
                     for i in range(rng.randint(30, 60))]
            for t in tasks:
                t.spec = tasks[0].spec
                t.service_id = svc
                t.id = f"{tag}-{t.id}"
            order = np.array([rng.randrange(n_nodes) for _ in tasks],
                             np.int64)
            placed.append((tasks[0], tasks, order))
        return placed

    n_nodes = 24
    rng_mk = random.Random(7)
    waves = [mk_wave(rng_mk, n_nodes, tag) for tag in ("a", "b")]
    conc = [[make_info(api, random.Random(4), i) for i in range(n_nodes)]
            for _ in range(2)]
    ser = [[make_info(api, random.Random(4), i) for i in range(n_nodes)]
           for _ in range(2)]
    results = [None, None]

    def run(slot):
        results[slot] = torch_batch.apply_placements(conc[slot], waves[slot])

    for _ in range(3):
        ts = [threading.Thread(target=run, args=(slot,)) for slot in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        serial = [torch_batch.apply_placements(ser[s], waves[s])
                  for s in (0, 1)]
        assert results == serial
        for s in (0, 1):
            assert_infos_equal(conc[s], ser[s], f"slot {s}")


def test_apply_wave_native_matches_python_and_jax():
    """apply_wave over TaskGroups (the id lists ride along) in both walks
    and in the JAX package, on one-shot waves encoded in each package."""
    from test_torch_placement import random_cluster

    out = {}
    for side, native_walk in (("torch", True), ("torch", False),
                              ("jax", True)):
        api, _mod, batch = SIDES[side]
        infos, groups = random_cluster(api, 77, n_nodes=40, n_groups=5,
                                       max_tasks=60)
        p = api.encode.encode(infos, groups)
        counts = batch.cpu_schedule_encoded(p)
        orders = batch.materialize_orders(p, counts)
        kw = {} if side == "jax" else {"native_walk": native_walk}
        n = batch.apply_wave(p.row_infos, p.groups, orders, **kw)
        assert n == int(counts.sum()) > 0
        out[(side, native_walk)] = infos
    assert_infos_equal(out[("torch", True)], out[("torch", False)])
    assert_infos_equal(out[("torch", True)], out[("jax", True)])


# ---------------------------------------------------------------- tree_copy
def _catalog(api):
    """One object of every table, plus rich tasks, a service, a node and a
    cluster (after the JAX package's copy catalog)."""
    o, s, t = api.objects, api.specs, api.types
    reps = []
    for cls in (o.Task, o.Service, o.Node, o.Cluster, o.Secret, o.Config,
                o.Network, o.Volume, o.Extension, o.Resource):
        obj = cls(id=f"cat-{cls.TABLE}")
        ann = s.Annotations(name=f"n-{cls.TABLE}", labels={"a": "b"})
        if hasattr(obj, "spec") and hasattr(obj.spec, "annotations"):
            obj.spec.annotations = ann
        elif hasattr(obj, "annotations"):
            obj.annotations = ann
        reps.append(obj)
    for i in range(2):
        task = o.Task(id=f"copy-task-{i:03d}", service_id="svc-copy",
                      slot=i + 1)
        task.desired_state = t.TaskState.RUNNING
        task.status.state = t.TaskState.ASSIGNED
        task.spec.resources.reservations.generic = {"gpu": 2}
        task.spec.resources.reservations.named_generic = {"fpga": {"a", "b"}}
        task.spec.placement = s.Placement(
            constraints=["node.labels.zone == a"],
            preferences=[s.PlacementPreference(
                spread_descriptor="node.labels.r")])
        task.endpoint = s.EndpointSpec(ports=[s.PortConfig(
            protocol="tcp", target_port=80, published_port=8080,
            publish_mode="host")])
        task.networks = [{"id": "netA", "addresses": ["10.0.0.4/24"]}]
        task.volumes = ["vol-1", "vol-2"]
        reps.append(task)
    node = o.Node(id="copy-node")
    node.description = s.NodeDescription(
        hostname="h1", resources=s.Resources(
            nano_cpus=8_000_000_000, memory_bytes=16 << 30,
            generic={"gpu": 4}, named_generic={"fpga": {"x"}}),
        plugins=[("Volume", "benchfs")])
    node.status.state = t.NodeStatusState.READY
    reps.append(node)
    return reps


def _mutate(obj):
    if isinstance(obj, dict):
        obj["__mut__"] = 1
    elif isinstance(obj, list):
        obj.append("__mut__")
    elif isinstance(obj, set):
        obj.add("__mut__")
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, (dict, list, set)) or (
                    dataclasses.is_dataclass(v) and not isinstance(v, type)):
                _mutate(v)


def test_tree_copy_matches_deepcopy_catalog():
    """StoreObject.copy (the native tree copier) equals deepcopy on every
    table and shares no mutable state with the original."""
    assert native.load() is not None
    for obj in _catalog(SIDES["torch"][0]):
        snapshot = copy.deepcopy(obj)
        cp = obj.copy()
        assert cp == snapshot == obj, type(obj).__name__
        assert cp is not obj
        _mutate(cp)
        cp.meta.version.index += 1
        assert obj == snapshot, f"copy aliased {type(obj).__name__}"


def test_deepcopy_spec_uses_the_tree_copier():
    from swarmkit_tpu_torch.api.specs import deepcopy_spec

    task = _catalog(SIDES["torch"][0])[-2]
    spec = deepcopy_spec(task.spec)
    assert spec == task.spec and spec is not task.spec
    spec.placement.constraints.append("x")
    assert task.spec.placement.constraints == ["node.labels.zone == a"]


def test_tree_copy_fallback_for_unknown_subtree():
    """A subtree outside the object model (a plain class) goes through the
    fallback and still deep-copies."""
    class Odd:
        def __init__(self):
            self.payload = [1, 2, 3]

        def __eq__(self, other):
            return isinstance(other, Odd) and other.payload == self.payload

    task = _catalog(SIDES["torch"][0])[-2]
    task.log_driver = Odd()
    cp = native.load().tree_copy(task, copy.deepcopy)
    assert cp == task
    cp.log_driver.payload.append(4)
    assert task.log_driver.payload == [1, 2, 3]


def test_without_the_native_module_python_paths_run(monkeypatch):
    """Where the module cannot be built, load() gives None: the copies and
    the commit walk take their pure-Python paths with the same results."""
    from swarmkit_tpu_torch.api.specs import deepcopy_spec

    api = SIDES["torch"][0]
    with_c = walk_trace("torch", 3, True)
    monkeypatch.setattr(native, "load", lambda: None)
    task = _catalog(api)[-2]
    assert task.copy() == task and deepcopy_spec(task.spec) == task.spec
    without = walk_trace("torch", 3, True)
    assert with_c[1] == without[1]
    assert_infos_equal(with_c[0], without[0])
