"""The node-sharded resident tick of the PyTorch port against the JAX
package on the CPU.

`MeshResidentPlacement(enc, make_mesh(k, device="cpu"))` keeps the carry as
k shard tensors a field and runs every kernel as its plain PyTorch version:
K23 (the sharded delta scatter), K1 once per shard, K20/K21 one step a
group, K24 (the sharded counts pull), K8 once per shard. The JAX package's
`ResidentPlacement(enc, mesh=make_mesh(8))` runs on the conftest's 8
virtual CPU devices. Both sides encode clusters built from the same seeds
in their own package, except the CSI twin, whose volume set only the JAX
package has: there both ticks take the JAX encoder's problems (the port's
tick reads only numpy arrays from its encoder). Per wave the counts, the
joined carry and the upload counters must be equal; every output is
integer or bool, so the tolerance is exact equality. The kernels
themselves are held against the plain versions on the card
(tests/test_torch_gpu_resident_mesh.py).

The JAX side runs each scenario once per module (the `reference`
fixture), on three cluster sizes, so that few mesh ticks compile.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from swarmkit_tpu.models import cluster_step as jax_cluster_step
from swarmkit_tpu.ops import pipeline as jax_pipeline
from swarmkit_tpu.ops import resident as jax_resident
from swarmkit_tpu.parallel import mesh as jax_mesh
from swarmkit_tpu.scheduler import batch as jax_batch
from swarmkit_tpu.scheduler import encode as jax_encode
from swarmkit_tpu_torch.models import cluster_step as torch_cluster_step
from swarmkit_tpu_torch.ops import pipeline as torch_pipeline
from swarmkit_tpu_torch.ops import resident as torch_resident
from swarmkit_tpu_torch.ops import resident_mesh as torch_rm
from swarmkit_tpu_torch.parallel import mesh as torch_mesh
from swarmkit_tpu_torch.scheduler import batch as torch_batch
from swarmkit_tpu_torch.scheduler import encode as torch_encode

torch.set_num_threads(1)

SPLITS = (1, 2, 8)
COUNTERS = ("uploads_full", "uploads_delta_rows", "uploads_group_tables",
            "uploads_h2d_bytes")


def _side(name):
    if name == "jax":
        return SimpleNamespace(cluster=jax_cluster_step.example_cluster,
                               encode=jax_encode, batch=jax_batch,
                               pipeline=jax_pipeline)
    return SimpleNamespace(cluster=torch_cluster_step.example_cluster,
                           encode=torch_encode, batch=torch_batch,
                           pipeline=torch_pipeline)


class TorchMesh(torch_rm.MeshResidentPlacement):
    """The port's mesh tick, tallying the placeholder delta set that the
    JAX package ships (and counts in `uploads_h2d_bytes`) on every tick
    without deltas. The port ships nothing then."""

    placeholder_bytes = 0

    def schedule_async(self, p):
        rows = self.uploads_delta_rows
        pending = super().schedule_async(p)
        if self.uploads_delta_rows == rows:
            _np, kp, plp, pvp, rp, sp = self._padded_dims(p)
            self.placeholder_bytes += (4 + 1 + 4 * kp + 8 + plp + pvp
                                       + 4 * rp + 4 + 4 * sp)
        return pending


def resident_of(side, enc, k):
    if side == "jax":
        return jax_resident.ResidentPlacement(enc, mesh=jax_mesh.make_mesh(8))
    return TorchMesh(enc, torch_mesh.make_mesh(k, device="cpu"))


def counters(rp) -> tuple:
    full, rows, tables, h2d = (getattr(rp, c) for c in COUNTERS)
    return full, rows, tables, h2d + getattr(rp, "placeholder_bytes", 0)


def renamed(groups, tag):
    """The same services as a new wave: fresh task ids."""
    for g in groups:
        for t in g.tasks:
            t.id = f"{tag}-{t.id}"
        g.ids = [t.id for t in g.tasks]
    return groups


def commit(side, infos, p, counts):
    """Oracle parity and the apply_counts contract: one add_task per
    placed task."""
    batch = _side(side).batch
    np.testing.assert_array_equal(counts, batch.cpu_schedule_encoded(p))
    by_node = {i.node.id: i for i in infos}
    task_by_id = {t.id: t for g in p.groups for t in g.tasks}
    for tid, nid in batch.materialize(p, counts).items():
        assert by_node[nid].add_task(task_by_id[tid])


def tick(side, enc, rp, infos, p):
    counts = rp.schedule(p)
    commit(side, infos, p, counts)
    assert enc.apply_counts(p, counts)
    rp.after_apply(p, counts)
    return counts


def assert_runs_equal(want, got):
    assert len(want) == len(got)
    for w, ((wc, ws, wn), (gc, gs, gn)) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(gc, wc, err_msg=f"wave {w}")
        assert list(gs) == list(ws) == list(torch_resident.STATE_FIELDS)
        for f in ws:
            np.testing.assert_array_equal(gs[f], ws[f],
                                          err_msg=f"wave {w} {f}")
        if wn is not None:
            assert gn == wn, f"wave {w}: counters {gn} != {wn}"


@pytest.fixture(scope="module")
def reference():
    """The JAX side of each scenario, run once for the module."""
    cache = {}

    def get(name, fn):
        if name not in cache:
            cache[name] = fn()
        return cache[name]
    return get


# ------------------------------------------------------ plain K23 and K24
def _shard(a, k, axis=0):
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in np.split(a, k, axis=axis)]


def _carry(rng, Np, K=4, PL=2, PV=4, R=3, S=8):
    return [rng.rand(Np) < 0.5, rng.randint(-1, 9, (Np, K)).astype(np.int32),
            rng.randint(0, 4, (Np, 2)).astype(np.int32),
            rng.rand(Np, PL) < 0.5, rng.rand(Np, PV) < 0.5,
            rng.randint(-5, 99, (Np, R)).astype(np.int32),
            rng.randint(0, 50, Np).astype(np.int32),
            rng.randint(0, 5, (S, Np)).astype(np.int32)]


def _deltas(rng, N, D, n_dirty, like):
    """D padded delta rows of n_dirty distinct global rows in [0, N): the
    padding repeats the first dirty row with its data."""
    dirty = np.sort(rng.choice(N, n_dirty, replace=False))
    pos = np.concatenate([np.arange(n_dirty), np.zeros(D - n_dirty, int)])
    fresh = _carry(rng, n_dirty, like[1].shape[1], like[3].shape[1],
                   like[4].shape[1], like[5].shape[1], like[7].shape[0])
    rows = [a[pos] for a in fresh[:7]]
    return [dirty[pos].astype(np.int32)] + rows + [
        np.ascontiguousarray(fresh[7][:, pos])]


@pytest.mark.parametrize("extra", [0, 3], ids=["divisible", "ragged"])
@pytest.mark.parametrize("k", SPLITS)
def test_delta_scatter_plain_matches_numpy(k, extra):
    """K23's plain version: every row into shard i // n at row i % n,
    duplicate padding rows included, against the same scatter on the
    joined numpy carry."""
    rng = np.random.RandomState(10 * k + extra)
    N = 5 * k + extra                    # real rows; the carry is padded
    n = -(-N // k)
    carry = _carry(rng, k * n)
    deltas = _deltas(rng, N, 16, min(N, 9), carry)
    want = [a.copy() for a in carry]
    idx = deltas[0].astype(np.int64)
    for a, d in zip(want[:7], deltas[1:8]):
        a[idx] = d
    want[7][:, idx] = deltas[8]
    state = [_shard(a, k, torch_rm.MESH_STATE_AXES[f])
             for f, a in zip(torch_resident.STATE_FIELDS, carry)]
    torch_rm.sharded_delta_scatter(state,
                                   [torch.from_numpy(d) for d in deltas])
    for f, w, shards in zip(torch_resident.STATE_FIELDS, want, state):
        got = torch.cat(shards, dim=torch_rm.MESH_STATE_AXES[f]).numpy()
        np.testing.assert_array_equal(got, w, err_msg=f)


def test_delta_scatter_refuses_rows_outside_the_carry():
    rng = np.random.RandomState(0)
    carry = _carry(rng, 16)
    state = [_shard(a, 2, torch_rm.MESH_STATE_AXES[f])
             for f, a in zip(torch_resident.STATE_FIELDS, carry)]
    deltas = [torch.from_numpy(d) for d in _deltas(rng, 16, 4, 2, carry)]
    deltas[0][1] = 16
    with pytest.raises(ValueError, match="outside"):
        torch_rm.sharded_delta_scatter(state, deltas)


def _sharded_counts(rng, k, N, G=5, density=0.1, top=40):
    n = -(-N // k)
    counts = np.zeros((G, k * n), np.int32)
    hit = rng.rand(G, N) < density
    counts[:, :N] = np.where(hit, rng.randint(1, top, (G, N)), 0)
    return counts, _shard(counts, k, axis=1)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("extra", [0, 3], ids=["divisible", "ragged"])
@pytest.mark.parametrize("k", SPLITS)
def test_counts_pull_plain_matches_numpy(k, extra, compact):
    """K24's plain version, both forms, against numpy and against the
    one-device K6/K7 plain versions on the joined counts: the dense
    window, and the sparse pack with kk above and equal to the nonzero
    count (cell 0 nonzero for k = 1, so padding repeats its value)."""
    rng = np.random.RandomState(20 * k + extra + compact)
    N = 40 * k + extra
    counts, shards = _sharded_counts(rng, k, N)
    if k == 1:
        counts[0, 0] = shards[0][0, 0] = 7
    g = 4                                # a window short of the groups
    dtype = np.int16 if compact else np.int32
    joined = torch.from_numpy(np.ascontiguousarray(counts))
    dense = torch_rm.sharded_counts_pull(shards, g, N, compact)
    assert dense.dtype == (torch.int16 if compact else torch.int32)
    np.testing.assert_array_equal(dense.numpy(),
                                  counts[:g, :N].astype(dtype))
    assert torch.equal(dense, torch_resident.counts_window_plain(
        joined, g, N, compact))
    flat = counts[:g, :N].reshape(-1)
    nnz = int(np.count_nonzero(flat))
    for kk in (nnz, 1 << nnz.bit_length()):
        idx, vals = torch_rm.sharded_counts_pull(shards, g, N, compact, kk)
        want_idx = np.zeros(kk, np.int64)
        want_idx[:nnz] = np.flatnonzero(flat)[:kk]
        np.testing.assert_array_equal(idx.numpy(), want_idx)
        np.testing.assert_array_equal(vals.numpy(),
                                      flat[want_idx].astype(dtype))
        w_idx, w_vals = torch_resident.sparse_counts_plain(joined, g, N, kk,
                                                           compact)
        assert torch.equal(idx, w_idx) and torch.equal(vals, w_vals)


def test_wrappers_refuse_other_devices():
    """K23 and K24 run their plain versions only for CPU tensors; a device
    without a kernel, or two devices, raise."""
    counts = [torch.zeros((2, 4), dtype=torch.int32, device="meta")] * 2
    with pytest.raises(ValueError, match="meta"):
        torch_rm.sharded_counts_pull(counts, 2, 8, True)
    with pytest.raises(ValueError):
        torch_rm.sharded_counts_pull(
            [torch.zeros((2, 4), dtype=torch.int32), counts[1]], 2, 8, True,
            4)
    rng = np.random.RandomState(1)
    carry = _carry(rng, 8)
    state = [_shard(a, 2, torch_rm.MESH_STATE_AXES[f])
             for f, a in zip(torch_resident.STATE_FIELDS, carry)]
    deltas = [torch.from_numpy(d) for d in _deltas(rng, 8, 2, 2, carry)]
    deltas[0] = deltas[0].to("meta")
    with pytest.raises(ValueError):
        torch_rm.sharded_delta_scatter(state, deltas)


# --------------------------------------------- twins of the mesh scale-out
def two_waves(side, n_nodes=131, n_groups=3, tasks_per_group=24):
    """tests/test_mesh_scaleout.py `_two_waves` in the side's package."""
    cluster = _side(side).cluster
    infos, w0 = cluster(n_nodes=n_nodes, n_groups=n_groups,
                        tasks_per_group=tasks_per_group)
    _, w1 = cluster(n_nodes=n_nodes, n_groups=n_groups,
                    tasks_per_group=tasks_per_group)
    return infos, w0, renamed(w1, "w1")


def steady_run(side, k=8, strategy="spread"):
    """Two waves of the same services, then the first node replaced by a
    new object (a full re-encode of its row) and the first wave again:
    per wave (counts, carry, counters), with the port's steady-tick
    contract checked on the way."""
    api = _side(side)
    infos, w0, w1 = two_waves(side)
    enc = api.encode.IncrementalEncoder(strategy=strategy)
    rp = resident_of(side, enc, k)
    out = []
    p0 = enc.encode(infos, w0)
    out.append((tick(side, enc, rp, infos, p0), rp.pull_state(),
                counters(rp)))
    p1 = enc.encode(infos, w1)
    assert enc.last_dirty == 0, "steady wave must find zero dirty rows"
    before = counters(rp)
    carry = [[t.data_ptr() for t in f] for f in rp._state] \
        if side == "torch" else None
    out.append((tick(side, enc, rp, infos, p1), rp.pull_state(),
                counters(rp)))
    if side == "torch":
        full, rows, tables, h2d = counters(rp)
        assert (full, rows, tables) == before[:3], \
            "steady tick re-uploaded the carry or re-shipped group tables"
        assert h2d - before[3] < len(p1.node_ids) * 4
        assert p1.spread_rank is p0.spread_rank
        assert rp._gsrc[10] is p1.spread_rank
        assert rp._gsrc[7] is torch_resident._PLACEHOLDER_FALSE
        assert rp._gsrc[12] is torch_resident._PLACEHOLDER_VOLTOPO
        # the carry stayed where it was, k shards of n_s nodes a field
        assert [[t.data_ptr() for t in f] for f in rp._state] == carry
        n_s = rp._padded_dims(p1)[0] // k
        assert all(len(f) == k for f in rp._state)
        assert all(t.shape[0] == n_s for t in rp._state[0])
        assert all(t.shape[1] == n_s for t in rp._state[7])
    old = infos[0]
    infos[0] = type(old).new(old.node, dict(old.tasks),
                             old.available_resources.copy())
    p2 = enc.encode(infos, renamed(two_waves(side)[1], "w2"))
    assert p2.spread_rank is not p1.spread_rank, \
        "label-dirty encode reused stale spread ranks"
    np.testing.assert_array_equal(np.asarray(p2.spread_rank),
                                  np.asarray(p1.spread_rank))
    out.append((tick(side, enc, rp, infos, p2), rp.pull_state(),
                counters(rp)))
    return out


@pytest.mark.parametrize("k", SPLITS)
def test_steady_mesh_tick_matches_jax(reference, k):
    """test_mesh_scaleout.py::test_steady_mesh_tick_opcount_guard,
    ::test_group_table_identity_gate_and_spread_cache and
    ::test_placeholder_singletons_are_identity_stable: no second full
    upload, no group table and only placeholder-sized bytes on the steady
    wave, the carry not moved; then a replaced node re-encodes its row."""
    want = reference("steady", lambda: steady_run("jax"))
    assert_runs_equal(want, steady_run("torch", k))


@pytest.mark.parametrize("k", SPLITS)
def test_binpack_mesh_steady_tick_matches_jax(reference, k):
    """test_mesh_scaleout.py::test_binpack_mesh_steady_tick_opcount: K21
    under the same steady contract."""
    want = reference("binpack", lambda: steady_run("jax",
                                                   strategy="binpack"))
    assert_runs_equal(want, steady_run("torch", k, strategy="binpack"))


def csi_run(side, k=8):
    """test_mesh_scaleout.py::test_voltopo_tables_identity_stable_and_cached
    at 13 nodes (fewer than two a shard at k = 8): the vol-topo table is
    live, identity-stable, and not shipped on the steady wave."""
    from test_mesh_scaleout import _csi_cluster

    infos, vs, w0, w1 = _csi_cluster(n_nodes=13)
    enc = jax_encode.IncrementalEncoder()
    rp = resident_of(side, enc, k)
    out = []
    p0 = enc.encode(infos, w0, volume_set=vs)
    assert p0.vol_topo_any is True and p0.vol_topo.shape[1] > 0
    out.append((tick("jax", enc, rp, infos, p0), rp.pull_state(),
                counters(rp)))
    assert rp._gsrc[12] is p0.vol_topo
    p1 = enc.encode(infos, w1, volume_set=vs)
    assert p1.vol_topo is p0.vol_topo
    full, _rows, tables, _h2d = counters(rp)
    out.append((tick("jax", enc, rp, infos, p1), rp.pull_state(),
                counters(rp)))
    assert (rp.uploads_full, rp.uploads_group_tables) == (full, tables)
    placed = np.flatnonzero(out[-1][0].sum(axis=0) > 0)
    assert placed.size > 0 and not (placed % 3 == 1).any()
    return out


@pytest.mark.parametrize("k", SPLITS)
def test_voltopo_mesh_tick_matches_jax(reference, k):
    want = reference("csi", lambda: csi_run("jax"))
    assert_runs_equal(want, csi_run("torch", k))


def dryrun_waves(side, k=8):
    """__graft_entry__.dryrun_multichip's mesh pipeline: 160 x 8 + 7 nodes,
    9 groups of 120 tasks in 3 waves of 3 through TickPipeline(depth=2),
    every completed wave equal to the oracle; then the carry."""
    api = _side(side)
    infos, groups = api.cluster(n_nodes=160 * 8 + 7, n_groups=9,
                                tasks_per_group=120)
    enc = api.encode.IncrementalEncoder()
    rp = resident_of(side, enc, k)
    done = []

    def commit_cb(p, counts):
        commit(side, infos, p, counts)
        done.append(counts)

    pipe = api.pipeline.TickPipeline(enc, rp, commit_cb, depth=2)
    n = 0
    for w in range(3):
        n += len(pipe.tick(infos, renamed(groups[3 * w:3 * (w + 1)],
                                          f"w{w}")))
    n += len(pipe.flush())
    assert n == len(done) == 3
    return [(c, None, None) for c in done[:-1]] + [
        (done[-1], rp.pull_state(), counters(rp))]


@pytest.mark.parametrize("k", SPLITS)
def test_dryrun_mesh_pipeline_matches_jax(reference, k):
    want = reference("dryrun", lambda: dryrun_waves("jax"))
    got = dryrun_waves("torch", k)
    for w, ((wc, ws, _), (gc, gs, _)) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(gc, wc, err_msg=f"wave {w}")
    assert_runs_equal(want[-1:], got[-1:])


def odd_reservations(groups):
    """Reservations that are not quantum multiples: the kernels' quantized
    fold and the host's raw fold differ, so after_apply queues correction
    rows (global row indices) for the next dispatch."""
    q = torch_encode.CPU_QUANTUM
    for gi, g in enumerate(groups):
        g.tasks[0].spec.resources.reservations.nano_cpus = q + q // 2 + gi
    return groups


def async_run(side, k=8):
    """TickPipeline(depth=3, async_commit=True) over 7 waves of 131 nodes
    with odd reservations: a node joins and one leaves before wave 3
    (remap: a cold re-upload), invalidate() before wave 4, task completions
    on 5 nodes before wave 5 (delta rows). Counts wave for wave, then the
    carry after the flush."""
    api = _side(side)
    infos, _ = api.cluster(n_nodes=131, n_groups=6, tasks_per_group=20)
    joiner = api.cluster(n_nodes=132, n_groups=1, tasks_per_group=1)[0][-1]
    enc = api.encode.IncrementalEncoder()
    rp = resident_of(side, enc, k)
    done = []

    def commit_cb(p, counts):
        commit(side, infos, p, counts)
        done.append(counts)

    pipe = api.pipeline.TickPipeline(enc, rp, commit_cb, depth=3,
                                     async_commit=True)
    try:
        for w in range(7):
            if w == 3:
                pipe.barrier()
                infos.append(joiner)
                infos.pop(7)
            if w == 4:
                rp.invalidate()
            if w == 5:
                pipe.barrier()
                busy = [i for i in infos if i.tasks][:5]
                for info in busy:
                    info.remove_task(next(iter(info.tasks.values())))
            groups = api.cluster(n_nodes=1, n_groups=6,
                                 tasks_per_group=20)[1][w % 2::2]
            pipe.tick(infos, renamed(odd_reservations(groups), f"w{w}"))
        pipe.flush()
    finally:
        pipe.close()
    assert len(done) == 7
    if side == "torch":
        assert rp.uploads_full >= 3 and rp.uploads_delta_rows > 0
    return [(c, None, None) for c in done[:-1]] + [
        (done[-1], rp.pull_state(), counters(rp))]


@pytest.mark.parametrize("k", SPLITS)
def test_async_pipeline_with_churn_matches_jax(reference, k):
    want = reference("async", lambda: async_run("jax"))
    got = async_run("torch", k)
    for w, ((wc, _, _), (gc, _, _)) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(gc, wc, err_msg=f"wave {w}")
    assert_runs_equal(want[-1:], got[-1:])


# ---------------------------------------------- the port's own contracts
def _one_device_and_mesh(n_nodes, k, waves=2):
    """The port's one-device tick and its mesh tick over the same waves;
    (counts, carry) per wave of each."""
    out = []
    for mesh in (None, k):
        infos, groups = torch_cluster_step.example_cluster(
            n_nodes=n_nodes, n_groups=4, tasks_per_group=6)
        enc = torch_encode.IncrementalEncoder()
        rp = (torch_resident.ResidentPlacement(enc, device="cpu")
              if mesh is None else
              torch_rm.MeshResidentPlacement(
                  enc, torch_mesh.make_mesh(mesh, device="cpu")))
        run = []
        for w in range(waves):
            p = enc.encode(infos, renamed(odd_reservations(groups), f"w{w}"))
            run.append((tick("torch", enc, rp, infos, p), rp.pull_state()))
        out.append(run)
    return out


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("n_nodes", [5, 13])
def test_phantom_nodes_stay_ineligible(n_nodes, k):
    """N < 2k: whole shards of phantom pad nodes. The counts equal the
    one-device tick's, the real rows of the carry too, and no phantom row
    folds anything."""
    one, mesh = _one_device_and_mesh(n_nodes, k)
    for (oc, os_), (mc, ms) in zip(one, mesh):
        np.testing.assert_array_equal(mc, oc)
        for f, ax in torch_rm.MESH_STATE_AXES.items():
            real = [slice(None)] * ms[f].ndim
            real[ax] = slice(0, n_nodes)
            np.testing.assert_array_equal(ms[f][tuple(real)],
                                          os_[f][tuple(real)], err_msg=f)
            pad = list(real)
            pad[ax] = slice(n_nodes, None)
            assert not ms[f][tuple(pad)].any(), f"phantom {f} not zero"


@pytest.mark.parametrize("k", SPLITS)
def test_refused_group_marks_the_carry_stale(k):
    """test_torch_int32_guard.py's contract on the mesh tick: a group whose
    capacity sum reaches 2^31 (48 nodes, 16 of them eligible at n_tasks
    2^27, no resource need) is refused when the counts are read, the
    carry is marked stale, and the next tick re-uploads and places as the
    one-device tick does."""
    results = []
    for mesh in (None, k):
        infos, groups = torch_cluster_step.example_cluster(
            n_nodes=48, n_groups=2, tasks_per_group=4)
        enc = torch_encode.IncrementalEncoder()
        rp = (torch_resident.ResidentPlacement(enc, device="cpu")
              if mesh is None else
              torch_rm.MeshResidentPlacement(
                  enc, torch_mesh.make_mesh(mesh, device="cpu")))
        p = enc.encode(infos, groups)
        assert int(p.need_res[0].sum()) == 0
        p.n_tasks[0] = 1 << 27
        with pytest.raises(ValueError, match="2\\^31"):
            rp.schedule(p)
        assert rp.needs_full_upload(p)
        full = rp.uploads_full
        p = enc.encode(infos, renamed(groups, "again"))
        results.append((tick("torch", enc, rp, infos, p), rp.pull_state()))
        assert rp.uploads_full == full + 1
    (oc, os_), (mc, ms) = results
    np.testing.assert_array_equal(mc, oc)
    np.testing.assert_array_equal(ms["total0"][:48], os_["total0"][:48])


def test_shard_count_must_be_a_power_of_two():
    enc = torch_encode.IncrementalEncoder()
    with pytest.raises(ValueError, match="power of two"):
        torch_rm.MeshResidentPlacement(
            enc, torch_mesh.make_mesh(3, device="cpu"))
    with pytest.raises(ValueError, match="nodes"):
        torch_rm.MeshResidentPlacement(
            enc, torch_mesh.make_mesh(2, axis="managers", device="cpu"))
    rp = torch_rm.MeshResidentPlacement(
        enc, torch_mesh.make_mesh(4, device="cpu"))
    assert rp.mesh.size == 4 and rp.device.type == "cpu"


def test_no_cuda_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc = torch_encode.IncrementalEncoder()
    for mesh in (8, None):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_rm.MeshResidentPlacement(enc, mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_rm.MeshResidentPlacement(enc, torch_mesh.make_mesh(8))
