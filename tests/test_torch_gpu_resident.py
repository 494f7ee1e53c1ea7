"""The resident tick's CUDA kernels (K5-K8) against their plain PyTorch
versions, and the resident tick and pipeline on the card against the same
on the CPU. Every test here is marked `gpu` and skips without a CUDA
device; the file imports neither JAX nor the JAX package, so on a machine
without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_resident.py

Outputs are integer or bool: the tolerance is exact equality.
"""
import numpy as np
import pytest
import torch

from swarmkit_tpu_torch.models import cluster_step as torch_cluster_step
from swarmkit_tpu_torch.ops import pipeline as torch_pipeline
from swarmkit_tpu_torch.ops import resident as torch_resident
from swarmkit_tpu_torch.scheduler import batch as torch_batch
from swarmkit_tpu_torch.scheduler import encode as torch_encode

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _state_and_deltas(rng, N, D, n_dirty, K=8, PL=4, PV=8, R=4, S=32):
    state = [rng.rand(N) < 0.5, rng.randint(-1, 9, (N, K)).astype(np.int32),
             rng.randint(0, 4, (N, 2)).astype(np.int32),
             rng.rand(N, PL) < 0.5, rng.rand(N, PV) < 0.5,
             rng.randint(-5, 99, (N, R)).astype(np.int32),
             rng.randint(0, 50, N).astype(np.int32),
             rng.randint(0, 5, (S, N)).astype(np.int32)]
    dirty = np.sort(rng.choice(N, n_dirty, replace=False))
    pos = np.concatenate([np.arange(n_dirty), np.zeros(D - n_dirty, int)])
    rows = [dirty.astype(np.int32), rng.rand(n_dirty) < 0.5,
            rng.randint(-1, 9, (n_dirty, K)).astype(np.int32),
            rng.randint(0, 4, (n_dirty, 2)).astype(np.int32),
            rng.rand(n_dirty, PL) < 0.5, rng.rand(n_dirty, PV) < 0.5,
            rng.randint(-5, 99, (n_dirty, R)).astype(np.int32),
            rng.randint(0, 50, n_dirty).astype(np.int32)]
    deltas = [r[pos] for r in rows]
    deltas.append(np.ascontiguousarray(
        rng.randint(0, 5, (S, n_dirty)).astype(np.int32)[:, pos]))
    return state, deltas


@pytest.mark.parametrize("n,d,n_dirty", [(64, 1, 1), (16384, 64, 37),
                                         (131072, 512, 300)])
def test_delta_scatter_kernel_matches_plain(cuda, n, d, n_dirty):
    state, deltas = _state_and_deltas(np.random.RandomState(n), n, d,
                                      n_dirty)
    got = [torch.from_numpy(a).to(cuda) for a in state]
    want = [torch.from_numpy(a.copy()) for a in state]
    before = torch_resident.resident_delta_scatter.launches
    torch_resident.resident_delta_scatter(
        got, [torch.from_numpy(a).to(cuda) for a in deltas])
    torch_resident.resident_delta_scatter(
        want, [torch.from_numpy(a) for a in deltas])
    torch.cuda.synchronize()
    assert torch_resident.resident_delta_scatter.launches == before + 1
    for name, g, w in zip(torch_resident.STATE_FIELDS, got, want):
        assert torch.equal(g.cpu(), w), name


def _counts(seed, gp, np_b, g, n, density):
    rng = np.random.RandomState(seed)
    c = np.zeros((gp, np_b), np.int32)
    c[:g, :n] = np.where(rng.rand(g, n) < density,
                         rng.randint(1, 600, (g, n)), 0)
    return c


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (32, 16384, 20, 10000),
                                   (32, 131072, 20, 100000)])
def test_counts_window_kernel_matches_plain(cuda, shape, compact):
    gp, np_b, g, n = shape
    counts = torch.from_numpy(_counts(1, gp, np_b, g, n, 0.3)).to(cuda)
    before = torch_resident.counts_window.launches
    got = torch_resident.counts_window(counts, g, n, compact)
    want = torch_resident.counts_window_plain(counts, g, n, compact)
    torch.cuda.synchronize()
    assert torch_resident.counts_window.launches == before + 1
    assert got.dtype == want.dtype and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("shape,density", [
    ((1, 8, 1, 5), 0.5), ((32, 16384, 20, 10000), 0.01),
    ((32, 131072, 20, 100000), 0.004), ((32, 131072, 20, 100000), 0.0)])
def test_sparse_counts_kernel_matches_plain(cuda, shape, density, compact):
    gp, np_b, g, n = shape
    host = _counts(2, gp, np_b, g, n, density)
    host[0, 0] = 3 if density else 0       # the padding's value, live
    counts = torch.from_numpy(host).to(cuda)
    nnz = int(np.count_nonzero(host[:g, :n]))
    k = 1 << (nnz + 5).bit_length()
    before = torch_resident.sparse_counts.launches
    got = torch_resident.sparse_counts(counts, g, n, k, compact)
    want = torch_resident.sparse_counts_plain(counts, g, n, k, compact)
    torch.cuda.synchronize()
    assert torch_resident.sparse_counts.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("rows,cols,nnz", [(1, 1, 0), (32, 16384, 0),
                                           (32, 131072, 9000),
                                           (32, 16384, 200000)])
def test_svc_matrix_build_kernel_matches_plain(cuda, rows, cols, nnz):
    rng = np.random.RandomState(rows + nnz)
    flat = np.sort(rng.choice(rows * cols, nnz, replace=False)) \
        .astype(np.int32)
    vals = rng.randint(1, 99, nnz).astype(np.int32)
    idx_t, val_t = torch.from_numpy(flat).to(cuda), \
        torch.from_numpy(vals).to(cuda)
    before = torch_resident.svc_matrix_build.launches
    got = torch_resident.svc_matrix_build(idx_t, val_t, rows, cols)
    want = torch_resident.svc_matrix_build_plain(idx_t, val_t, rows, cols)
    torch.cuda.synchronize()
    assert torch_resident.svc_matrix_build.launches == before + 1
    assert torch.equal(got, want)


def _commit(infos):
    by_node = {i.node.id: i for i in infos}

    def commit(p, counts):
        orders = torch_batch.materialize_orders(p, counts)
        rows = [by_node[nid] for nid in p.node_ids]
        assert torch_batch.apply_wave(rows, p.groups, orders) \
            == int(counts.sum())
    return commit


def _waves(n_waves, n_groups, tasks):
    out = []
    for w in range(n_waves):
        _, groups = torch_cluster_step.example_cluster(1, n_groups, tasks, w)
        for g in groups:
            g.spec_version = w + 1
            for t in g.tasks:
                t.id = f"w{w}-{t.id}"
            g.ids = [t.id for t in g.tasks]
        out.append(groups)
    return out


@pytest.mark.parametrize("depth", [1, 3])
def test_pipeline_on_card_matches_cpu(cuda, depth):
    """The flagship cluster's waves (spread trees up to LMAX 3, padded to
    4 levels; host ports; generic resources) through TickPipeline on the
    card and on the CPU: every wave equal, and equal to the oracle."""
    res = {}
    for dev in (cuda, "cpu"):
        infos, _ = torch_cluster_step.example_cluster(600, 0, 0, 5)
        enc = torch_encode.IncrementalEncoder()
        rp = torch_resident.ResidentPlacement(enc, device=dev)
        pipe = torch_pipeline.TickPipeline(enc, rp, _commit(infos),
                                           depth=depth)
        done = []
        for groups in _waves(5, 8, 60):
            done.extend(pipe.tick(infos, groups))
        done.extend(pipe.flush())
        res[str(dev)] = (done, rp.pull_state(),
                         (rp.uploads_full, rp.uploads_delta_rows,
                          rp.uploads_group_tables, rp.uploads_h2d_bytes))
    (got, st_g, n_g), (want, st_w, n_w) = res["cuda"], res["cpu"]
    assert len(got) == len(want) == 5
    for (p, c), (_q, w) in zip(got, want):
        np.testing.assert_array_equal(c, w)
        np.testing.assert_array_equal(c, torch_batch.cpu_schedule_encoded(p))
    for k in st_g:
        np.testing.assert_array_equal(st_g[k], st_w[k], err_msg=k)
    assert n_g == n_w
