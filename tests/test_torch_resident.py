"""Device-resident placement of the PyTorch port against the JAX reference.

The port's `ResidentPlacement` runs on `device="cpu"` (every kernel is its
plain PyTorch version) and the JAX package's on its CPU backend, over
clusters built from the same seed in either package. Per tick, the counts,
all eight carried state arrays and the four upload counters (the H2D bytes
as the JAX package counts them, see `TorchResident`) must be equal,
and the counts must equal the CPU oracle: every output is integer or bool,
so the tolerance is exact equality. The plain versions of kernels K5-K8 are
held against the JAX functions they replace on the same numpy inputs; the
kernels themselves are held against the plain versions on the card
(tests/test_torch_gpu_resident.py).
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarmkit_tpu.ops import resident as jax_resident
from swarmkit_tpu.scheduler import batch as jax_batch
from swarmkit_tpu.scheduler import encode as jax_encode
from swarmkit_tpu_torch.ops import pipeline as torch_pipeline
from swarmkit_tpu_torch.ops import placement as torch_placement
from swarmkit_tpu_torch.ops import resident as torch_resident
from swarmkit_tpu_torch.scheduler import batch as torch_batch
from test_torch_placement import JAX_API, TORCH_API, random_group, random_node

torch.set_num_threads(1)

NOW = 1000.0
SIDES = {"jax": (JAX_API, jax_resident, jax_batch),
         "torch": (TORCH_API, torch_resident, torch_batch)}
COUNTERS = ("uploads_full", "uploads_delta_rows", "uploads_group_tables",
            "uploads_h2d_bytes")


# ------------------------------------------------------------- generators
def make_info(api, rng, i):
    node = random_node(api, rng, i)
    return api.nodeinfo.NodeInfo.new(node, {},
                                     node.description.resources.copy())


def make_task(api, rng, svc, ti):
    t = api.objects.Task(id=f"run-{svc}-{ti:04d}", service_id=svc,
                         slot=ti + 1)
    t.desired_state = api.types.TaskState.RUNNING
    t.status.state = api.types.TaskState.RUNNING
    t.spec.resources.reservations.nano_cpus = \
        rng.randint(0, 2) * api.encode.CPU_QUANTUM
    t.spec.resources.reservations.memory_bytes = \
        rng.randint(0, 2) * api.encode.MEM_QUANTUM
    return t


def mutate(api, rng, infos, next_node_id, step):
    """A random batch of cluster mutations, in place: joins, leaves, tasks
    run and removed, failures, wholesale node replacement."""
    for _ in range(rng.randint(1, 4)):
        op = rng.random()
        if op < 0.2 and len(infos) < 24:
            infos.append(make_info(api, rng, next_node_id))
            next_node_id += 1
        elif op < 0.3 and len(infos) > 5:
            infos.pop(rng.randrange(len(infos)))
        elif op < 0.55:
            info = rng.choice(infos)
            svc = f"svc-{rng.randrange(6):03d}"
            info.add_task(make_task(api, rng, svc, rng.randrange(10_000)))
        elif op < 0.7 and any(i.tasks for i in infos):
            info = rng.choice([i for i in infos if i.tasks])
            tid = rng.choice(list(info.tasks))
            info.remove_task(info.tasks[tid])
        elif op < 0.85:
            info = rng.choice(infos)
            for _ in range(rng.randint(1, 6)):
                info.task_failed((f"svc-{rng.randrange(6):03d}", 1), now=NOW)
        else:
            i = rng.randrange(len(infos))
            old = infos[i]
            node = random_node(api, rng, step * 1000 + i)
            node.id = old.node.id
            infos[i] = api.nodeinfo.NodeInfo.new(
                node, {}, node.description.resources.copy())
    return next_node_id


plain_group = random_group       # quantum-multiple reservations


def odd_group(api, rng, gi, n_tasks, wave=0):
    """Reservations that are NOT quantum multiples: the quantized kernel
    fold and the host's raw fold diverge, so correction rows ship."""
    g = random_group(api, rng, gi, n_tasks, wave)
    spec = g.tasks[0].spec
    spec.resources.reservations.nano_cpus = \
        rng.randint(0, 3 * api.encode.CPU_QUANTUM)
    spec.resources.reservations.memory_bytes = \
        rng.randint(0, 4 * api.encode.MEM_QUANTUM)
    return g


def make_waves(api, rng, step, group_maker, max_groups=4):
    groups, seen = [], set()
    for _ in range(rng.randint(1, max_groups)):
        g = group_maker(api, rng, rng.randrange(8), rng.randint(1, 12))
        if g.key not in seen:
            seen.add(g.key)
            # task ids unique ACROSS steps: a reused id makes add_task a
            # no-op
            for t in g.tasks:
                t.id = f"s{step}-{t.id}"
            g.tasks.sort(key=lambda t: t.id)
            groups.append(g)
    return groups


def service_group(api, svc, version, n_tasks):
    """No constraints, preferences or ports, one-quantum CPU need."""
    tasks = []
    for ti in range(n_tasks):
        t = api.objects.Task(id=f"pt-{svc}-v{version}-{ti:04d}",
                             service_id=svc, slot=ti + 1)
        t.desired_state = api.types.TaskState.RUNNING
        t.status.state = api.types.TaskState.PENDING
        tasks.append(t)
    spec = tasks[0].spec
    spec.resources.reservations.nano_cpus = api.encode.CPU_QUANTUM
    spec.resources.reservations.memory_bytes = 0
    for t in tasks[1:]:
        t.spec = spec
    return api.encode.TaskGroup(service_id=svc, spec_version=version,
                                tasks=tasks)


# -------------------------------------------------------------- helpers
class TorchResident(torch_resident.ResidentPlacement):
    """The port's ResidentPlacement, tallying the placeholder delta set
    that the JAX package ships, and counts in `uploads_h2d_bytes`, on every
    tick without deltas (its jitted tick takes the arrays either way). The
    port ships nothing then."""

    placeholder_bytes = 0

    def schedule_async(self, p):
        rows = self.uploads_delta_rows
        pending = super().schedule_async(p)
        if self.uploads_delta_rows == rows:
            # d_idx, d_ready, d_val, d_plat, d_plug, d_port, d_avail,
            # d_total: one row each; d_svc: one column
            _np, kp, plp, pvp, rp, sp = self._padded_dims(p)
            self.placeholder_bytes += (4 + 1 + 4 * kp + 8 + plp + pvp
                                       + 4 * rp + 4 + 4 * sp)
        return pending


def resident_of(side, enc):
    _api, mod, _batch = SIDES[side]
    if side == "torch":
        return TorchResident(enc, device="cpu")
    return mod.ResidentPlacement(enc)


def counters(rp) -> tuple:
    """The four upload counters, the H2D bytes counted as the JAX package
    counts them."""
    full, rows, tables, h2d = (getattr(rp, k) for k in COUNTERS)
    return full, rows, tables, h2d + getattr(rp, "placeholder_bytes", 0)


def expected_device_fold(p, counts):
    """What the kernels' in-scan updates leave on the device for the real
    [N] window (tests/test_resident.py)."""
    total = p.total0 + counts.sum(axis=0).astype(np.int32)
    avail = (p.avail_res.astype(np.int64)
             - counts.astype(np.int64).T @ p.need_res.astype(np.int64)
             ).astype(np.int32)
    port = p.port_used0.copy()
    for gi in range(counts.shape[0]):
        port |= p.group_ports[gi][None, :] & (counts[gi] > 0)[:, None]
    return total, avail, port


def assert_fold(st, p, counts, what=""):
    N = len(p.node_ids)
    total, avail, port = expected_device_fold(p, counts)
    np.testing.assert_array_equal(st["total0"][:N], total, err_msg=what)
    np.testing.assert_array_equal(
        st["avail_res"][:N, :p.avail_res.shape[1]], avail, err_msg=what)
    np.testing.assert_array_equal(
        st["port_used"][:N, :p.port_used0.shape[1]], port, err_msg=what)
    np.testing.assert_array_equal(st["ready"][:N], p.ready, err_msg=what)
    np.testing.assert_array_equal(
        st["node_val"][:N, :p.node_val.shape[1]], p.node_val, err_msg=what)


def assert_states_equal(a: dict, b: dict, what=""):
    assert list(a) == list(b) == list(torch_resident.STATE_FIELDS)
    for k in a:
        assert a[k].shape == b[k].shape, f"{what} {k}"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def apply_tick(side, enc, rp, infos, p, counts):
    """What a scheduler does after a tick on the happy path."""
    batch = SIDES[side][2]
    by_node = {i.node.id: i for i in infos}
    task_by_id = {t.id: t for g in p.groups for t in g.tasks}
    n_added = sum(by_node[nid].add_task(task_by_id[tid])
                  for tid, nid in batch.materialize(p, counts).items())
    assert n_added == int(counts.sum())
    assert enc.apply_counts(p, counts)
    rp.after_apply(p, counts)


def run_trace(side, seed, steps=6, group_maker=plain_group):
    """The mirror of tests/test_resident.py run_trace on one side: per step
    (counts, carried state, upload counters), each step's counts checked
    against that side's CPU oracle and its carry against the fold."""
    api, _mod, batch = SIDES[side]
    rng = random.Random(seed)
    infos = [make_info(api, rng, i) for i in range(12)]
    next_node_id = 12
    enc = api.encode.IncrementalEncoder()
    rp = resident_of(side, enc)
    out = []
    for step in range(steps):
        if step:
            next_node_id = mutate(api, rng, infos, next_node_id, step)
        groups = make_waves(api, rng, step, group_maker)
        p = enc.encode(infos, groups, now=NOW)
        counts = rp.schedule(p)
        np.testing.assert_array_equal(
            counts, batch.cpu_schedule_encoded(p),
            err_msg=f"{side} seed {seed} step {step}")
        st = rp.pull_state()
        assert_fold(st, p, counts, f"{side} seed {seed} step {step}")
        out.append((counts, st, counters(rp)))
        apply_tick(side, enc, rp, infos, p, counts)
    return out


# ------------------------------------------- plain K5-K8 against the JAX
def _state_and_deltas(rng, N=32, D=8, K=4, PL=2, PV=4, R=3, S=8,
                      n_dirty=5):
    state = [rng.rand(N) < 0.5, rng.randint(-1, 9, (N, K)).astype(np.int32),
             rng.randint(0, 4, (N, 2)).astype(np.int32),
             rng.rand(N, PL) < 0.5, rng.rand(N, PV) < 0.5,
             rng.randint(-5, 99, (N, R)).astype(np.int32),
             rng.randint(0, 50, N).astype(np.int32),
             rng.randint(0, 5, (S, N)).astype(np.int32)]
    dirty = np.sort(rng.choice(N, n_dirty, replace=False))
    idx = np.full(D, dirty[0])
    idx[:n_dirty] = dirty
    rows = [rng.rand(n_dirty) < 0.5,
            rng.randint(-1, 9, (n_dirty, K)).astype(np.int32),
            rng.randint(0, 4, (n_dirty, 2)).astype(np.int32),
            rng.rand(n_dirty, PL) < 0.5, rng.rand(n_dirty, PV) < 0.5,
            rng.randint(-5, 99, (n_dirty, R)).astype(np.int32),
            rng.randint(0, 50, n_dirty).astype(np.int32)]
    # the padding repeats the first dirty row WITH its data
    pos = np.concatenate([np.arange(n_dirty), np.zeros(D - n_dirty, int)])
    deltas = [idx.astype(np.int32)] + [r[pos] for r in rows]
    svc_cols = rng.randint(0, 5, (S, n_dirty)).astype(np.int32)
    deltas.append(np.ascontiguousarray(svc_cols[:, pos]))
    return state, deltas


@pytest.mark.parametrize("seed", range(3))
def test_delta_scatter_plain_matches_jax(seed):
    state, deltas = _state_and_deltas(np.random.RandomState(seed))
    j_idx = jnp.asarray(deltas[0])
    want = [np.asarray(jnp.asarray(a).at[j_idx].set(jnp.asarray(d)))
            for a, d in zip(state[:7], deltas[1:8])]
    want.append(np.asarray(jnp.asarray(state[7]).at[:, j_idx].set(
        jnp.asarray(deltas[8]))))
    got = [torch.from_numpy(a.copy()) for a in state]
    torch_resident.resident_delta_scatter(
        got, [torch.from_numpy(d) for d in deltas])
    for name, w, g in zip(torch_resident.STATE_FIELDS, want, got):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def _padded_counts(rng, gp=8, np_b=64, g=5, n=50, density=0.1, top=40):
    counts = np.zeros((gp, np_b), np.int32)
    hit = rng.rand(g, n) < density
    counts[:g, :n] = np.where(hit, rng.randint(1, top, (g, n)), 0)
    return counts


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("seed", range(2))
def test_counts_window_plain_matches_jax(seed, compact):
    counts = _padded_counts(np.random.RandomState(seed))
    want = np.asarray(jax_resident._slice_counts(
        jnp.asarray(counts).astype(jnp.int16 if compact else jnp.int32),
        g=5, n=50))
    got = torch_resident.counts_window(torch.from_numpy(counts), 5, 50,
                                       compact)
    assert got.is_contiguous()
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_sparse_counts_plain_matches_jax(seed, compact):
    """Ascending flat indices padded with index 0, and cell 0's value in
    the padded slots, element for element (cell 0 is nonzero for seed 0)."""
    rng = np.random.RandomState(seed)
    counts = _padded_counts(rng)
    if seed == 0:
        counts[0, 0] = 7
    k = 1 << int(np.count_nonzero(counts) + 3).bit_length()
    src = jnp.asarray(counts).astype(jnp.int16 if compact else jnp.int32)
    w_idx, w_val = (np.asarray(a) for a in
                    jax_resident._sparse_counts(src, g=5, n=50, k=k))
    g_idx, g_val = torch_resident.sparse_counts(torch.from_numpy(counts), 5,
                                                50, k, compact)
    assert g_idx.dtype == torch.int32
    assert str(g_val.dtype).split(".")[-1] == str(w_val.dtype)
    np.testing.assert_array_equal(g_idx.numpy(), w_idx)
    np.testing.assert_array_equal(g_val.numpy(), w_val)


@pytest.mark.parametrize("nnz", [0, 1, 37])
def test_svc_matrix_build_plain_matches_jax(nnz):
    rng = np.random.RandomState(nnz)
    sp, np_b = 8, 64
    flat = np.sort(rng.choice(sp * np_b, nnz, replace=False)).astype(np.int32)
    vals = rng.randint(1, 9, nnz).astype(np.int32)
    want = np.asarray(jnp.zeros(sp * np_b, np.int32).at[
        jnp.asarray(flat)].add(jnp.asarray(vals)).reshape(sp, np_b))
    got = torch_resident.svc_matrix_build(torch.from_numpy(flat),
                                          torch.from_numpy(vals), sp, np_b)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_refuse_other_devices():
    """K5-K8 run their plain version only for CPU tensors; tensors on a
    device without a kernel, or on two devices, raise."""
    counts = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        torch_resident.counts_window(counts, 2, 4, True)
    with pytest.raises(ValueError, match="meta"):
        torch_resident.sparse_counts(counts, 2, 4, 4, True)
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        torch_resident.svc_matrix_build(idx, idx.to("meta"), 4, 8)
    state, deltas = _state_and_deltas(np.random.RandomState(0))
    state = [torch.from_numpy(a) for a in state]
    deltas = [torch.from_numpy(d) for d in deltas]
    deltas[0] = deltas[0].to("meta")
    with pytest.raises(ValueError):
        torch_resident.resident_delta_scatter(state, deltas)


# ------------------------------------------------------ resident traces
@pytest.mark.parametrize("seed, maker", [(40, "quantum"), (41, "odd")])
def test_trace_matches_jax(seed, maker):
    """Churned multi-tick traces; odd reservations force correction rows."""
    group_maker = odd_group if maker == "odd" else plain_group
    want = run_trace("jax", seed, group_maker=group_maker)
    got = run_trace("torch", seed, group_maker=group_maker)
    for step, ((wc, ws, wn), (gc, gs, gn)) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(gc, wc, err_msg=f"step {step}")
        assert_states_equal(gs, ws, f"step {step}")
        assert gn == wn, f"step {step}: counters {gn} != {wn}"
    if maker == "odd":
        assert got[-1][2][1] > 0, "no delta rows: the correction path is idle"


def _svc_paths(side):
    """Cold (all-zero), sparse and dense service-matrix uploads, the first
    sparse one then consumed by a delta tick."""
    api, _mod, batch = SIDES[side]
    rng = random.Random(11)
    infos = [make_info(api, rng, i) for i in range(32)]
    enc = api.encode.IncrementalEncoder()
    rp = resident_of(side, enc)
    out = []
    waves = [(False, [(f"svc-{k}", 1, 1) for k in range(6)]),
             (True, [("svc-0", 2, 2), ("svc-1", 2, 1)]),
             (False, [("svc-0", 3, 3), ("svc-2", 2, 2)]),
             (True, [(f"svc-{k}", 4, 32) for k in range(6)]),
             (True, [("svc-0", 5, 3)])]
    for invalidate, spec in waves:
        if invalidate:
            rp.invalidate()
        p = enc.encode(infos, [service_group(api, *s) for s in spec],
                       now=NOW)
        assert rp.needs_full_upload(p) == (invalidate or not out)
        counts = rp.schedule(p)
        np.testing.assert_array_equal(counts, batch.cpu_schedule_encoded(p))
        st = rp.pull_state()
        assert not st["svc_mat"][:, len(p.node_ids):].any()
        out.append((counts, st, counters(rp)))
        apply_tick(side, enc, rp, infos, p, counts)
    return out, rp


def test_cold_svc_matrix_paths_match_jax():
    (want, _), (got, rp) = _svc_paths("jax"), _svc_paths("torch")
    for step, ((wc, ws, wn), (gc, gs, gn)) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(gc, wc, err_msg=f"wave {step}")
        assert_states_equal(gs, ws, f"wave {step}")
        assert gn == wn, f"wave {step}: counters {gn} != {wn}"
    # four full uploads: zeros (cold), sparse (waves 1 and 3) and dense
    # (wave 4, after 6 x 32 tasks)
    assert rp.uploads_svc == {"zeros": 1, "sparse": 2, "dense": 1}


def _surgery_and_churn(side):
    """invalidate() after the CPU oracle handled a tick behind the
    resident's back, then a node join + leave (remap -> full upload)."""
    api, _mod, batch = SIDES[side]
    rng = random.Random(9)
    infos = [make_info(api, rng, i) for i in range(10)]
    enc = api.encode.IncrementalEncoder()
    rp = resident_of(side, enc)
    out = []

    def tick(gi, n):
        p = enc.encode(infos, [plain_group(api, rng, gi, n)], now=NOW)
        counts = rp.schedule(p)
        np.testing.assert_array_equal(counts, batch.cpu_schedule_encoded(p))
        out.append((counts, rp.pull_state(), counters(rp)))
        apply_tick(side, enc, rp, infos, p, counts)

    tick(0, 4)
    p_mid = enc.encode(infos, [plain_group(api, rng, 1, 3)], now=NOW)
    c_mid = batch.cpu_schedule_encoded(p_mid)
    by_node = {i.node.id: i for i in infos}
    task_by_id = {t.id: t for g in p_mid.groups for t in g.tasks}
    for tid, nid in batch.materialize(p_mid, c_mid).items():
        by_node[nid].add_task(task_by_id[tid])
    enc.apply_counts(p_mid, c_mid)
    rp.invalidate()
    tick(2, 5)
    assert rp.uploads_full == 2
    infos.append(make_info(api, rng, 99))
    infos.pop(0)
    tick(3, 6)
    assert rp.uploads_full == 3
    return out


def test_invalidate_and_node_churn_match_jax():
    want, got = _surgery_and_churn("jax"), _surgery_and_churn("torch")
    for step, ((wc, ws, wn), (gc, gs, gn)) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(gc, wc, err_msg=f"tick {step}")
        assert_states_equal(gs, ws, f"tick {step}")
        assert gn == wn


def test_sparse_pull_matches_jax_and_dense():
    """A node-heavy, task-light tick pulls (idx, val) pairs; densified, they
    equal the JAX package's sparse pull, the dense window and the oracle."""
    out = {}
    for side in SIDES:
        api, mod, batch = SIDES[side]
        rng = random.Random(3)
        infos = [make_info(api, rng, i) for i in range(64)]
        enc = api.encode.IncrementalEncoder()
        rp = resident_of(side, enc)
        p = enc.encode(infos, [plain_group(api, random.Random(5), 0, 5)],
                       now=NOW)
        counts = rp.schedule_async(p).get()
        np.testing.assert_array_equal(counts, batch.cpu_schedule_encoded(p))
        out[side] = counts
    assert rp.pulls == {"dense": 0, "sparse": 1}, "sparse pull not taken"
    np.testing.assert_array_equal(out["torch"], out["jax"])
    dense = torch_resident.counts_window(
        torch.from_numpy(np.pad(out["torch"], ((0, 1), (0, 64)))), 1, 64,
        True)
    np.testing.assert_array_equal(dense.numpy(), out["torch"])


# ---------------------------------------------------- padded spread levels
@pytest.mark.parametrize("seed", range(2))
def test_padded_lmax_tree_matches_jax(seed):
    """LMAX 3 pads to 4 levels, the last real level repeated. The plain
    tree fill on the padded table equals the unpadded one, and resident
    ticks equal the JAX package's and the oracle."""
    jp = jax_encode.encode(*_tree_cluster(JAX_API, seed), now=NOW,
                           strategy="topology", topology="node.labels.zone")
    assert jp.spread_rank.shape[1] == 3
    padded = jax_encode.pad_buckets(jp)
    assert padded.spread_rank.shape[1] == 4
    G, N = jp.extra_mask.shape
    args = jax_encode.kernel_args(jp)
    want, _, _ = torch_placement.schedule_groups(*args, device="cpu")
    got, _, _ = torch_placement.schedule_groups(
        *jax_encode.kernel_args(padded), device="cpu")
    np.testing.assert_array_equal(got.numpy()[:G, :N], want.numpy())
    np.testing.assert_array_equal(want.numpy(),
                                  jax_batch.cpu_schedule_encoded(jp))

    res = {}
    for side in SIDES:
        api, _mod, batch = SIDES[side]
        infos, groups = _tree_cluster(api, seed)
        enc = api.encode.IncrementalEncoder(strategy="topology",
                                            topology="node.labels.zone")
        rp = resident_of(side, enc)
        res[side] = []
        for wave in range(2):
            if wave:
                groups = [random_group(api, random.Random(seed + 7), gi, 9,
                                       wave) for gi in range(3)]
                groups[0].spec.placement.preferences = [
                    api.specs.PlacementPreference(
                        spread_descriptor=f"node.labels.{k}")
                    for k in ("zone", "disk")]
            p = enc.encode(infos, groups, now=NOW)
            assert p.spread_rank.shape[1] == 3
            counts = rp.schedule(p)
            np.testing.assert_array_equal(counts,
                                          batch.cpu_schedule_encoded(p))
            st = rp.pull_state()
            assert_fold(st, p, counts, f"{side} wave {wave}")
            res[side].append((counts, st, counters(rp)))
            apply_tick(side, enc, rp, infos, p, counts)
    for (wc, ws, wn), (gc, gs, gn) in zip(res["jax"], res["torch"]):
        np.testing.assert_array_equal(gc, wc)
        assert_states_equal(gs, ws)
        assert gn == wn


def _tree_cluster(api, seed):
    from test_torch_placement import random_cluster

    return random_cluster(api, 8100 + seed, n_nodes=48, n_groups=4,
                          max_tasks=30, tree=True)


# ------------------------------------------------------------ no device
def test_no_cuda_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc = TORCH_API.encode.IncrementalEncoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_resident.ResidentPlacement(enc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_pipeline.TickPipeline(
            enc, torch_resident.ResidentPlacement(enc), lambda p, c: None)
