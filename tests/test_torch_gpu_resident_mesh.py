"""The node-sharded resident tick's CUDA kernels (K23, K24) against their
plain PyTorch versions, and `MeshResidentPlacement` on the card against
the same tick on the CPU. Every test here is marked `gpu` and skips without
a CUDA device; the file imports neither JAX nor the JAX package, so on a
machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_resident_mesh.py

Outputs are integer or bool: the tolerance is exact equality.
"""
import numpy as np
import pytest
import torch

from swarmkit_tpu_torch.models import cluster_step as torch_cluster_step
from swarmkit_tpu_torch.ops import pipeline as torch_pipeline
from swarmkit_tpu_torch.ops import resident as torch_resident
from swarmkit_tpu_torch.ops import resident_mesh as torch_rm
from swarmkit_tpu_torch.parallel import mesh as torch_mesh
from swarmkit_tpu_torch.scheduler import batch as torch_batch
from swarmkit_tpu_torch.scheduler import encode as torch_encode

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _carry(rng, Np, K=8, PL=4, PV=8, R=4, S=32):
    return [rng.rand(Np) < 0.5, rng.randint(-1, 9, (Np, K)).astype(np.int32),
            rng.randint(0, 4, (Np, 2)).astype(np.int32),
            rng.rand(Np, PL) < 0.5, rng.rand(Np, PV) < 0.5,
            rng.randint(-5, 99, (Np, R)).astype(np.int32),
            rng.randint(0, 50, Np).astype(np.int32),
            rng.randint(0, 5, (S, Np)).astype(np.int32)]


def _sharded(carry, k, dev):
    return [[torch.from_numpy(np.ascontiguousarray(x)).to(dev)
             for x in np.split(a, k, axis=torch_rm.MESH_STATE_AXES[f])]
            for f, a in zip(torch_resident.STATE_FIELDS, carry)]


def _deltas(rng, N, D, n_dirty, like, dev):
    dirty = np.sort(rng.choice(N, n_dirty, replace=False))
    pos = np.concatenate([np.arange(n_dirty), np.zeros(D - n_dirty, int)])
    fresh = _carry(rng, n_dirty, like[1].shape[1], like[3].shape[1],
                   like[4].shape[1], like[5].shape[1], like[7].shape[0])
    out = [dirty[pos].astype(np.int32)] + [a[pos] for a in fresh[:7]] + [
        np.ascontiguousarray(fresh[7][:, pos])]
    return [torch.from_numpy(a).to(dev) for a in out]


@pytest.mark.parametrize("k,n,N,D,n_dirty", [
    (1, 64, 61, 1, 1), (2, 8192, 16_000, 64, 37), (8, 16_384, 100_000, 512,
                                                   300),
    (8, 2, 13, 16, 9)])
def test_delta_scatter_kernel_matches_plain(cuda, k, n, N, D, n_dirty):
    """One K23 launch for every row of every shard, duplicate padding rows
    included, with the kept pointer table and with one made in the call."""
    rng = np.random.RandomState(n + k)
    carry = _carry(rng, k * n)
    deltas = _deltas(rng, N, D, n_dirty, carry, cuda)
    got = _sharded(carry, k, cuda)
    table = torch_rm.scatter_table(got)
    again = _sharded(carry, k, cuda)
    want = _sharded(carry, k, "cpu")
    before = torch_rm.sharded_delta_scatter.launches
    torch_rm.sharded_delta_scatter(got, deltas, table)
    torch_rm.sharded_delta_scatter(again, deltas)
    torch_rm.sharded_delta_scatter_plain(want, [d.cpu() for d in deltas])
    torch.cuda.synchronize()
    assert torch_rm.sharded_delta_scatter.launches == before + 2
    for f, g, a, w in zip(torch_resident.STATE_FIELDS, got, again, want):
        for b in range(k):
            assert torch.equal(g[b].cpu(), w[b]), (f, b)
            assert torch.equal(a[b].cpu(), w[b]), (f, b)


def test_delta_scatter_kernel_skips_rows_outside(cuda):
    rng = np.random.RandomState(3)
    carry = _carry(rng, 64)
    got = _sharded(carry, 4, cuda)
    deltas = _deltas(rng, 64, 4, 4, carry, cuda)
    deltas[0][2] = 64
    deltas[0][3] = -1
    torch_rm.sharded_delta_scatter(got, deltas)
    want = _sharded(carry, 4, "cpu")
    torch_rm.sharded_delta_scatter_plain(
        want, [d[:2].cpu() if i < 8 else d[:, :2].cpu()
               for i, d in enumerate(deltas)])
    torch.cuda.synchronize()
    for f, g, w in zip(torch_resident.STATE_FIELDS, got, want):
        for b in range(4):
            assert torch.equal(g[b].cpu(), w[b]), (f, b)


def _counts(rng, k, N, G, density, dev):
    n = -(-N // k)
    counts = np.zeros((G, k * n), np.int32)
    hit = rng.rand(G, N) < density
    counts[:, :N] = np.where(hit, rng.randint(1, 40, (G, N)), 0)
    counts[0, 0] = 5
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in np.split(counts, k, axis=1)]


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("k,N,G,g,density", [
    (1, 10_000, 20, 20, 0.3), (2, 1_000, 8, 5, 0.05),
    (8, 100_000, 20, 20, 0.005), (8, 13, 3, 3, 0.5),
    (8, 10_000, 20, 17, 0.9)])
def test_counts_pull_kernel_matches_plain(cuda, k, N, G, g, density,
                                          compact):
    """K24's dense window and sparse pack (kk below, equal to and above the
    nonzero count) against the plain version and the one-device K6/K7
    plain versions on the joined counts."""
    rng = np.random.RandomState(N + k + g)
    counts = _counts(rng, k, N, G, density, cuda)
    joined = torch.cat(counts, dim=1).contiguous()
    before = torch_rm.sharded_counts_pull.launches
    dense = torch_rm.sharded_counts_pull(counts, g, N, compact)
    assert torch.equal(dense, torch_rm.sharded_counts_pull_plain(
        counts, g, N, compact))
    assert torch.equal(dense, torch_resident.counts_window_plain(
        joined, g, N, compact))
    nnz = int((joined[:g, :N] != 0).sum())
    for kk in sorted({max(1, nnz // 2), nnz, 1 << nnz.bit_length()}):
        idx, vals = torch_rm.sharded_counts_pull(counts, g, N, compact, kk)
        w_idx, w_vals = torch_rm.sharded_counts_pull_plain(counts, g, N,
                                                           compact, kk)
        o_idx, o_vals = torch_resident.sparse_counts_plain(joined, g, N, kk,
                                                           compact)
        assert torch.equal(idx, w_idx) and torch.equal(vals, w_vals), kk
        assert torch.equal(idx, o_idx) and torch.equal(vals, o_vals), kk
    torch.cuda.synchronize()
    assert torch_rm.sharded_counts_pull.launches > before + 1


def test_counts_pull_refuses_too_many_shards(cuda):
    counts = [torch.zeros((2, 1), dtype=torch.int32, device=cuda)] * (
        torch_rm.MAX_PULL_SHARDS + 1)
    with pytest.raises(ValueError, match="shards"):
        torch_rm.sharded_counts_pull(counts, 2, len(counts), True)


def _rename(groups, tag):
    for g in groups:
        for t in g.tasks:
            t.id = f"{tag}-{t.id}"
        g.ids = [t.id for t in g.tasks]
    return groups


def _run(dev, k, n_nodes, strategy, depth, async_commit):
    """Waves of the example cluster (spread trees, ports, generic
    resources; odd reservations: correction rows) through TickPipeline on
    the mesh tick, with task completions (delta rows) and one
    invalidate() mid-run."""
    kw = {"strategy": strategy}
    if strategy == "topology":
        kw["topology"] = "node.labels.zone"
    infos, _ = torch_cluster_step.example_cluster(n_nodes, 0, 0, 5)
    by_node = {i.node.id: i for i in infos}
    enc = torch_encode.IncrementalEncoder(**kw)
    rp = torch_rm.MeshResidentPlacement(
        enc, torch_mesh.make_mesh(k, device=dev))
    done = []

    def commit(p, counts):
        orders = torch_batch.materialize_orders(p, counts)
        rows = [by_node[nid] for nid in p.node_ids]
        assert torch_batch.apply_wave(rows, p.groups, orders) \
            == int(counts.sum())

    pipe = torch_pipeline.TickPipeline(enc, rp, commit, depth=depth,
                                       async_commit=async_commit)
    try:
        for w in range(6):
            if w == 3:
                pipe.barrier()
                for info in [i for i in infos if i.tasks][:7]:
                    info.remove_task(next(iter(info.tasks.values())))
            if w == 4:
                rp.invalidate()
            _, groups = torch_cluster_step.example_cluster(1, 8, 60, w)
            q = torch_encode.CPU_QUANTUM
            for gi, g in enumerate(groups):
                g.tasks[0].spec.resources.reservations.nano_cpus = \
                    q + q // 3 + gi
            done.extend(pipe.tick(infos, _rename(groups, f"w{w}")))
        done.extend(pipe.flush())
    finally:
        pipe.close()
    return done, rp


@pytest.mark.parametrize("k,n_nodes,strategy,depth,async_commit", [
    (8, 600, "spread", 3, True), (2, 601, "binpack", 1, False),
    (1, 600, "topology", 2, False), (8, 13, "spread", 2, True)])
def test_mesh_tick_on_card_matches_cpu(cuda, k, n_nodes, strategy, depth,
                                       async_commit):
    """The mesh tick on the card and on the CPU over the same waves: every
    wave equal, and equal to the oracle; the joined carries and the upload
    counters equal; K23 and K24 launched."""
    before = (torch_rm.sharded_delta_scatter.launches,
              torch_rm.sharded_counts_pull.launches)
    got, rp_g = _run(cuda, k, n_nodes, strategy, depth, async_commit)
    after = (torch_rm.sharded_delta_scatter.launches,
             torch_rm.sharded_counts_pull.launches)
    want, rp_w = _run("cpu", k, n_nodes, strategy, depth, async_commit)
    assert len(got) == len(want) == 6
    for (p, c), (_q, w) in zip(got, want):
        np.testing.assert_array_equal(c, w)
        np.testing.assert_array_equal(c, torch_batch.cpu_schedule_encoded(p))
    st_g, st_w = rp_g.pull_state(), rp_w.pull_state()
    for f in st_g:
        np.testing.assert_array_equal(st_g[f], st_w[f], err_msg=f)
    for c in ("uploads_full", "uploads_delta_rows", "uploads_group_tables",
              "uploads_h2d_bytes", "uploads_svc", "pulls"):
        assert getattr(rp_g, c) == getattr(rp_w, c), c
    assert after[0] > before[0] and after[1] >= before[1] + 6
