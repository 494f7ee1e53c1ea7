"""Placement parity of the PyTorch port against the JAX reference.

The same seeded clusters are built in both packages (the generators below
take a package's api modules as an argument), and the port's plain PyTorch
placement (`device="cpu"`) must equal the JAX `schedule_groups` and the
greedy CPU oracle exactly: every output is integer or bool, so the
tolerance is exact equality. The CUDA kernels are held against the same
plain versions on the card (tests/test_torch_gpu.py).
"""
import dataclasses
import importlib
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from swarmkit_tpu.ops import placement as jax_placement
from swarmkit_tpu.scheduler import batch as jax_batch
from swarmkit_tpu.scheduler import encode as jax_encode
from swarmkit_tpu_torch import convert
from swarmkit_tpu_torch.ops import placement as torch_placement
from swarmkit_tpu_torch.scheduler import batch as torch_batch

torch.set_num_threads(1)

LABEL_KEYS = ["zone", "disk", "tier"]
LABEL_VALS = ["a", "b", "c", "ssd", "hdd"]


def api_of(pkg: str) -> SimpleNamespace:
    """The modules a generator needs, from package `pkg`."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return SimpleNamespace(objects=mod("api.objects"), specs=mod("api.specs"),
                           types=mod("api.types"), encode=mod("scheduler.encode"),
                           nodeinfo=mod("scheduler.nodeinfo"))


JAX_API = api_of("swarmkit_tpu")
TORCH_API = api_of("swarmkit_tpu_torch")


def random_node(api, rng, i):
    s, t, e = api.specs, api.types, api.encode
    n = api.objects.Node(id=f"node-{i:04d}")
    n.status.state = (t.NodeStatusState.READY if rng.random() < 0.9
                      else t.NodeStatusState.DOWN)
    n.status.addr = f"10.0.{i % 256}.{(i * 7) % 256}"
    n.spec.availability = (t.NodeAvailability.ACTIVE if rng.random() < 0.9
                           else t.NodeAvailability.DRAIN)
    n.spec.annotations = s.Annotations(name=f"node-{i}", labels={
        k: rng.choice(LABEL_VALS) for k in LABEL_KEYS if rng.random() < 0.7
    })
    n.description = s.NodeDescription(
        hostname=f"host-{i}",
        platform=s.Platform(os=rng.choice(["linux", "windows"]),
                            architecture=rng.choice(["x86_64", "amd64",
                                                     "arm64"])),
        resources=s.Resources(
            nano_cpus=rng.randint(1, 16) * e.CPU_QUANTUM * 1000,
            memory_bytes=rng.randint(1, 64) * e.MEM_QUANTUM * 1024,
        ),
        plugins=[("Volume", "local"), ("Network", "overlay")]
        + ([("Volume", "nfs")] if rng.random() < 0.5 else []),
    )
    return n


def random_group(api, rng, gi, n_tasks, wave=0):
    s, e = api.specs, api.encode
    svc = f"svc-{gi:03d}"
    tasks = []
    for ti in range(n_tasks):
        t = api.objects.Task(id=f"task-w{wave}-{gi:03d}-{ti:05d}",
                             service_id=svc, slot=ti + 1)
        t.desired_state = api.types.TaskState.RUNNING
        tasks.append(t)
    spec = tasks[0].spec
    spec.resources.reservations.nano_cpus = rng.randint(0, 3) * e.CPU_QUANTUM
    spec.resources.reservations.memory_bytes = \
        rng.randint(0, 4) * e.MEM_QUANTUM
    choices = []
    if rng.random() < 0.5:
        choices.append(f"node.labels.{rng.choice(LABEL_KEYS)} "
                       f"{'==' if rng.random() < 0.7 else '!='} "
                       f"{rng.choice(LABEL_VALS)}")
    if rng.random() < 0.2:
        choices.append("node.platform.os == linux")
    if rng.random() < 0.1:
        choices.append("node.ip != 10.0.3.0/24")
    spec.placement = s.Placement(constraints=choices)
    if rng.random() < 0.5:
        prefs = [s.PlacementPreference(
            spread_descriptor=f"node.labels.{rng.choice(LABEL_KEYS)}")]
        if rng.random() < 0.4:
            prefs.append(s.PlacementPreference(
                spread_descriptor=f"node.labels.{rng.choice(LABEL_KEYS)}"))
        spec.placement.preferences = prefs
    if rng.random() < 0.3:
        spec.placement.platforms = [s.Platform(os="linux",
                                               architecture="x86_64")]
    if rng.random() < 0.2:
        spec.placement.max_replicas = rng.randint(1, 3)
    if rng.random() < 0.2:
        for t in tasks:
            t.endpoint = s.EndpointSpec(ports=[s.PortConfig(
                protocol="tcp", target_port=80,
                published_port=8000 + gi % 3, publish_mode="host")])
    if rng.random() < 0.2:
        # a "driver/source" mount needs Volume/nfs, which half the fleet
        # lacks: the plugin leg of the mask
        spec.runtime = s.ContainerSpec(mounts=[
            s.VolumeMount(source="nfs/data", target="/data")])
    for t in tasks[1:]:
        t.spec = tasks[0].spec
    return api.encode.TaskGroup(service_id=svc, spec_version=wave + 1,
                                tasks=tasks)


def random_cluster(api, seed, n_nodes=200, n_groups=None, max_tasks=200,
                   tree=False):
    """(infos, groups) from `seed`; the same seed gives the same cluster in
    either package. tree=True gives group 0 a two-level spread preference
    (zone, then disk), so the problem has LMAX >= 2."""
    rng = random.Random(seed)
    if n_groups is None:
        n_groups = rng.randint(3, 8)
    infos = []
    for i in range(n_nodes):
        node = random_node(api, rng, i)
        info = api.nodeinfo.NodeInfo.new(
            node, {}, node.description.resources.copy())
        # pre-existing load, incl. per-service counts (spread-tree totals)
        info.active_tasks_count = rng.randint(0, 5)
        for gi in range(n_groups):
            if rng.random() < 0.3:
                info.active_tasks_count_by_service[f"svc-{gi:03d}"] = \
                    rng.randint(1, 4)
        infos.append(info)
    groups = [random_group(api, rng, gi, rng.randint(1, max_tasks))
              for gi in range(n_groups)]
    if tree:
        groups[0].spec.placement.preferences = [
            api.specs.PlacementPreference(spread_descriptor=f"node.labels.{k}")
            for k in ("zone", "disk")]
    return infos, groups


def jax_problem(seed, strategy="spread", **kw):
    infos, groups = random_cluster(JAX_API, seed, **kw)
    topology = "node.labels.zone" if strategy == "topology" else None
    return jax_encode.encode(infos, groups, strategy=strategy,
                             topology=topology)


def problem_fields(p) -> dict:
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


def jax_schedule(p):
    """JAX schedule_groups on the bucket-padded problem (one compile per
    bucket), sliced back to the real window."""
    G, N = p.extra_mask.shape
    S = p.svc_count0.shape[0]
    counts, totals, svc = jax_placement.schedule_groups(
        *jax_encode.kernel_args(jax_encode.pad_buckets(p)))
    return (np.asarray(counts)[:G, :N], np.asarray(totals)[:N],
            np.asarray(svc)[:S, :N])


def torch_schedule(arrays):
    counts, totals, svc = torch_placement.schedule_groups(
        *convert.kernel_args_from_arrays(arrays, "cpu"), device="cpu")
    return counts.numpy(), totals.numpy(), svc.numpy()


def assert_schedule_parity(p):
    want = jax_schedule(p)
    got = torch_schedule(jax_encode.kernel_args(p))
    for name, w, g in zip(("counts", "totals", "svc_counts"), want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got[0], jax_batch.cpu_schedule_encoded(p))
    return got[0]


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("shape", ["flat", "tree", "topology"])
def test_schedule_groups_matches_jax(seed, shape):
    """Flat fill (LMAX 0), tree fill (the groups' own preferences) and the
    topology strategy (one more outer level: LMAX up to 3)."""
    p = jax_problem(1000 + seed, tree=shape == "tree",
                    strategy="topology" if shape == "topology" else "spread")
    if shape == "flat":
        G, _, N = p.spread_rank.shape
        p.spread_rank = np.zeros((G, 0, N), np.int32)
    else:
        assert p.spread_rank.shape[1] >= 1
    counts = assert_schedule_parity(p)
    assert (counts.sum(axis=1) <= p.n_tasks).all()


@pytest.mark.parametrize("seed", range(8))
def test_static_mask_matches_jax(seed):
    p = jax_problem(2000 + seed)
    a = dict(zip(jax_encode.KERNEL_ARG_FIELDS, jax_encode.kernel_args(p)))
    mask_args = ("ready", "node_val", "node_plat", "node_plugins",
                 "constraints", "plat_req", "req_plugins", "extra_mask",
                 "vol_topo")
    want = np.asarray(jax_placement.build_static_mask(
        *(a[f] for f in mask_args)))
    t = dict(zip(jax_encode.KERNEL_ARG_FIELDS,
                 convert.kernel_args_from_arrays(a, "cpu")))
    got = torch_placement.static_mask(*(t[f] for f in mask_args))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), jax_batch.cpu_static_mask(p))


def _with_vol_topo(p, rng):
    """Random CSI volume-topology rows over the problem's node_val columns:
    up to 3 mounts per group, 1-3 alternative rows per mount, 1-3 segments
    per row, values drawn from the column (or -1, matching nothing)."""
    G, N = p.extra_mask.shape
    K = p.node_val.shape[1]
    W = 1 + 2 * jax_encode.VOL_TOPO_SEGS
    rows = [[] for _ in range(G)]
    for gi in range(G):
        if rng.random() < 0.3:
            continue
        for m in range(rng.randint(1, 3)):
            for _ in range(rng.randint(1, 3)):
                row = [m]
                for _ in range(rng.randint(1, 3)):
                    col = rng.randrange(K)
                    val = (int(p.node_val[rng.randrange(N), col])
                           if rng.random() < 0.9 else -1)
                    row += [col, val]
                rows[gi].append(row + [-1] * (W - len(row)))
    VA = max(len(r) for r in rows)
    vt = np.full((G, VA, W), -1, np.int32)
    for gi, r in enumerate(rows):
        if r:
            vt[gi, :len(r)] = r
    p.vol_topo = vt
    p.vol_topo_any = VA > 0
    return p


@pytest.mark.parametrize("seed", range(6))
def test_vol_topo_rows_match_jax(seed):
    rng = random.Random(3000 + seed)
    p = _with_vol_topo(jax_problem(3000 + seed), rng)
    assert p.vol_topo.shape[1] > 0
    mask = torch_placement.static_mask_plain(*(
        torch.from_numpy(getattr(p, f)) for f in (
            "ready", "node_val", "node_plat", "node_plugins", "constraints",
            "plat_req", "req_plugins", "extra_mask", "vol_topo")))
    np.testing.assert_array_equal(mask.numpy(), jax_batch.cpu_static_mask(p))
    assert_schedule_parity(p)


@pytest.mark.parametrize("seed", range(4))
def test_host_ports_and_max_replicas_match_jax(seed):
    """Every group publishes one of two host ports (conflicts within the
    wave ride port_used) and half cap their replicas per node."""
    p = jax_problem(4000 + seed, n_nodes=60, max_tasks=80)
    G = p.extra_mask.shape[0]
    PV = p.port_used0.shape[1]
    gp = np.zeros((G, max(PV, 2)), bool)
    gp[np.arange(G), np.arange(G) % 2] = True
    p.group_ports = gp
    p.has_ports = np.ones(G, bool)
    pu = np.zeros((p.port_used0.shape[0], gp.shape[1]), bool)
    pu[:, :PV] = p.port_used0
    pu[::7, 1] = True
    p.port_used0 = pu
    p.max_replicas = np.where(np.arange(G) % 2, 2, 0).astype(np.int32)
    counts = assert_schedule_parity(p)
    per_port = [counts[np.arange(G) % 2 == k].sum(axis=0) for k in (0, 1)]
    assert max(c.max() for c in per_port) <= 1


@pytest.mark.parametrize("big", [False, True])
def test_compact_path_matches_jax(big):
    p = jax_problem(5000)
    arrays = list(jax_encode.kernel_args(p))
    if big:
        # n_tasks >= 2^15: the counts stay int32
        arrays[jax_encode.KERNEL_ARG_FIELDS.index("n_tasks")] = \
            np.full(p.extra_mask.shape[0], 40_000, np.int32)
    compact = int(arrays[11].max()) < (1 << 15)
    assert compact != big
    want = np.asarray(jax_placement.schedule_groups_compact(
        *arrays, compact=compact))
    got = torch_placement.schedule_groups_compact(*arrays, device="cpu")
    assert got.dtype == (torch.int32 if big else torch.int16)
    assert str(want.dtype) == ("int32" if big else "int16")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(3))
def test_schedule_encoded_on_port_problem(seed):
    """The port's EncodedProblem (carried over from the JAX problem) through
    the port's device backend and its CPU oracle."""
    p = jax_problem(6000 + seed)
    q = convert.encoded_problem_from_arrays(problem_fields(p))
    got = torch_batch.device_schedule_encoded(q, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, torch_batch.cpu_schedule_encoded(q))
    np.testing.assert_array_equal(got, jax_batch.cpu_schedule_encoded(p))


def test_inputs_are_checked_and_not_modified():
    p = jax_problem(7100)
    arrays = jax_encode.kernel_args(p)
    before = [a.copy() for a in arrays]
    torch_placement.schedule_groups(*arrays, device="cpu")
    for a, b in zip(arrays, before):
        np.testing.assert_array_equal(a, b)
    bad = list(arrays)
    bad[0] = bad[0].astype(np.int32)            # ready must be bool
    with pytest.raises(TypeError, match="ready"):
        torch_placement.schedule_groups(*bad, device="cpu")
    bad = list(arrays)
    bad[9] = bad[9][:-1]                        # total0 of the wrong N
    with pytest.raises(ValueError, match="total0"):
        torch_placement.schedule_groups(*bad, device="cpu")
