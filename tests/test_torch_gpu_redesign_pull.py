"""The redesigned K8 (svc matrix build: one launch of block-owned shares
while the pairs are few, else zero fill and scatter) and K24 (sharded
counts pull: a 1-D grid over shard segments, vector and scalar paths, the
shard pointers in a parameter sized to k) against their plain PyTorch
versions, on the card. Every test here is marked `gpu` and skips without a
CUDA device; the file imports neither JAX nor the JAX package, so on a
machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_redesign_pull.py

Outputs are integer: the tolerance is exact equality.
"""
import numpy as np
import pytest
import torch

from swarmkit_tpu_torch.ops import resident as torch_resident
from swarmkit_tpu_torch.ops import resident_mesh as torch_rm
from swarmkit_tpu_torch.ops.placement import _expect

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# ------------------------------------------------------------------ K8
def _pairs(rng, cells, nnz, repeats):
    """nnz flat indices in random order over [0, cells), `repeats` of them
    drawn again (so they sum), with cell 0 and cell cells - 1 among them;
    int32 values, some negative."""
    idx = rng.randint(0, cells, nnz).astype(np.int64)
    if nnz >= 2:
        idx[0], idx[-1] = cells - 1, 0
    if repeats and nnz:
        idx[rng.randint(0, nnz, repeats)] = idx[rng.randint(0, nnz, repeats)]
    rng.shuffle(idx)
    vals = rng.randint(-50, 99, nnz)
    return idx.astype(np.int32), vals.astype(np.int32)


def _build_against_plain(cuda, rows, cols, idx, vals):
    i_t = torch.from_numpy(idx).to(cuda)
    v_t = torch.from_numpy(vals).to(cuda)
    before = torch_resident.svc_matrix_build.launches
    got = torch_resident.svc_matrix_build(i_t, v_t, rows, cols)
    want = torch_resident.svc_matrix_build_plain(i_t, v_t, rows, cols)
    torch.cuda.synchronize()
    assert torch_resident.svc_matrix_build.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (rows, cols)
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("rows,cols,nnz,repeats", [
    (1, 1, 0, 0), (1, 1, 1, 0), (32, 16384, 0, 0), (32, 16384, 1, 0),
    (32, 16384, 277, 40), (32, 16384, 1024, 300), (32, 16384, 1100, 0),
    (32, 16384, 200_000, 5000), (3, 5, 9, 4), (7, 13, 60, 20),
    (1, 4097, 3, 1), (33, 1001, 2000, 500), (32, 131072, 0, 0),
    (32, 131072, 277, 50), (32, 131072, 9000, 100),
    (32, 131072, 100_000, 1000)])
def test_svc_matrix_build_matches_plain(cuda, rows, cols, nnz, repeats):
    # one launch (few pairs) and two (many), cells a multiple of 4 or not
    rng = np.random.RandomState(rows * 7 + cols + nnz)
    idx, vals = _pairs(rng, rows * cols, nnz, repeats)
    _build_against_plain(cuda, rows, cols, idx, vals)


def test_svc_matrix_build_sums_repeated_cells(cuda):
    idx = np.array([5, 0, 5, 14, 5, 0, 14], np.int32)
    vals = np.array([1, 2, 3, 4, 5, 6, 7], np.int32)
    got = _build_against_plain(cuda, 3, 5, idx, vals)
    want = np.zeros(15, np.int32)
    np.add.at(want, idx, vals)
    assert got.cpu().reshape(-1).tolist() == want.tolist()


@pytest.mark.parametrize("nnz", [10, 50_000])
def test_svc_matrix_build_skips_indices_outside(cuda, nnz):
    # both forms skip pairs whose index is outside [0, cells)
    rows, cols = 32, 16384
    cells = rows * cols
    rng = np.random.RandomState(nnz)
    idx, vals = _pairs(rng, cells, nnz, nnz // 10)
    bad = idx.copy()
    out = rng.rand(nnz) < 0.3
    bad[out] = np.where(rng.rand(out.sum()) < 0.5, -1 - idx[out],
                        cells + idx[out])
    got = torch_resident.svc_matrix_build(torch.from_numpy(bad).to(cuda),
                                          torch.from_numpy(vals).to(cuda),
                                          rows, cols)
    keep = ~out
    want = torch_resident.svc_matrix_build_plain(
        torch.from_numpy(idx[keep]), torch.from_numpy(vals[keep]), rows,
        cols)
    assert torch.equal(got.cpu(), want)


def test_svc_matrix_build_pairs_off_boundary(cuda):
    # pairs from views that start off a 16-byte boundary
    rng = np.random.RandomState(3)
    idx, vals = _pairs(rng, 32 * 16384, 301, 30)
    one = np.zeros(1, np.int32)
    i_buf = torch.from_numpy(np.concatenate([one, idx])).to(cuda)
    v_buf = torch.from_numpy(np.concatenate([one, vals])).to(cuda)
    got = torch_resident.svc_matrix_build(i_buf[1:], v_buf[1:], 32, 16384)
    want = torch_resident.svc_matrix_build_plain(i_buf[1:], v_buf[1:], 32,
                                                 16384)
    assert torch.equal(got, want)


def _expect_error(t, name, shape):
    try:
        _expect(t, name, torch.int32, shape)
    except (TypeError, ValueError) as e:
        return type(e), str(e)
    return None


@pytest.mark.parametrize("fault", ["idx int64", "vals int16", "vals short",
                                   "idx 2-D", "idx strided",
                                   "vals strided"])
def test_svc_matrix_build_refuses_as_the_checks(cuda, fault):
    """A call the kernel does not take raises what `_expect` raises on idx,
    then on vals, in that order."""
    idx = torch.arange(8, dtype=torch.int32, device=cuda)
    vals = torch.ones(8, dtype=torch.int32, device=cuda)
    if fault == "idx int64":
        idx = idx.long()
    elif fault == "vals int16":
        vals = vals.short()
    elif fault == "vals short":
        vals = vals[:5]
    elif fault == "idx 2-D":
        idx = idx.view(2, 4)
    elif fault == "idx strided":
        idx = torch.arange(16, dtype=torch.int32, device=cuda)[::2]
    else:
        vals = torch.ones(16, dtype=torch.int32, device=cuda)[::2]
    nnz = idx.shape[0]
    want = _expect_error(idx, "idx", (nnz,)) or \
        _expect_error(vals, "vals", (nnz,))
    assert want is not None
    with pytest.raises(want[0]) as got:
        torch_resident.svc_matrix_build(idx, vals, 4, 8)
    assert str(got.value) == want[1]


# ----------------------------------------------------------------- K24
def _shards(rng, k, n, Gc, density, offset=0, dev="cpu"):
    """k shard counts int32[Gc, n] (nonzero values everywhere, the padding
    columns and rows beyond any window included); with `offset` each shard
    is a view that starts that many int32 into its own buffer."""
    counts = np.where(rng.rand(Gc, k * n) < density,
                      rng.randint(1, 30_000, (Gc, k * n)), 0).astype(np.int32)
    counts[0, 0] = 7
    out = []
    for part in np.split(counts, k, axis=1):
        buf = torch.zeros(Gc * n + offset, dtype=torch.int32, device=dev)
        view = buf[offset:].view(Gc, n)
        view.copy_(torch.from_numpy(np.ascontiguousarray(part)))
        out.append(view)
    return out


PULL_SHAPES = [
    # k, n (shard width), N (window), Gc, g
    (1, 2048, 2048, 20, 20), (1, 10_001, 10_001, 3, 2),
    (2, 1002, 2000, 8, 5), (3, 1003, 3000, 4, 4), (3, 1003, 3009, 4, 4),
    (8, 2048, 10_000, 20, 20), (8, 2048, 10_000, 20, 17),
    (8, 2048, 10_001, 20, 20), (8, 2048, 16_384, 20, 20),
    (8, 16_384, 100_000, 20, 20), (8, 13, 100, 3, 3), (8, 14, 109, 5, 1),
    (256, 8, 2000, 4, 3), (256, 5, 1277, 2, 2), (256, 4, 1024, 3, 3),
    (8, 2048, 10_000, 20, 0), (8, 2048, 0, 20, 20), (2, 3, 1, 1, 1)]


def _pull_dense(cuda, counts, g, N, compact, vector):
    ns = counts[0].shape[1]
    before = torch_rm.sharded_counts_pull.launches
    got = torch_rm.sharded_counts_pull(counts, g, N, compact)
    torch.cuda.synchronize()
    assert torch_rm.sharded_counts_pull.launches == before + (g * N > 0)
    ptrs = [c.data_ptr() for c in counts]
    assert torch_rm.pull_vector(ptrs, got.data_ptr(), N, ns) == vector
    want = torch_rm.sharded_counts_pull_plain(counts, g, N, compact)
    joined = torch.cat(counts, dim=1).contiguous()
    assert got.dtype == want.dtype and got.shape == (g, N)
    assert torch.equal(got, want)
    assert torch.equal(got, torch_resident.counts_window_plain(
        joined, g, N, compact))


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("k,n,N,Gc,g", PULL_SHAPES)
def test_counts_pull_dense_matches_plain(cuda, k, n, N, Gc, g, compact):
    rng = np.random.RandomState(k * 1000 + n + N + g)
    counts = _shards(rng, k, n, Gc, 0.4, dev=cuda)
    _pull_dense(cuda, counts, g, N, compact, n % 4 == 0 and N % 4 == 0)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("k,n,N,Gc,g", [
    (8, 2048, 10_000, 20, 20), (1, 2048, 2048, 4, 4), (256, 8, 2000, 4, 3)])
def test_counts_pull_dense_scalar_path_off_boundary(cuda, k, n, N, Gc, g,
                                                    compact):
    # n and N multiples of 4, but every shard 4 bytes off a 16-byte
    # boundary: the scalar path, equal all the same
    rng = np.random.RandomState(k + n + N)
    counts = _shards(rng, k, n, Gc, 0.4, offset=1, dev=cuda)
    _pull_dense(cuda, counts, g, N, compact, False)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("k,n,N,Gc,g", [
    s for s in PULL_SHAPES if s[2] * s[4] > 0])
def test_counts_pull_sparse_matches_plain(cuda, k, n, N, Gc, g, compact):
    # kk below, at and above the nonzero count
    rng = np.random.RandomState(k * 1000 + n + N + g + 1)
    counts = _shards(rng, k, n, Gc, 0.05, dev=cuda)
    joined = torch.cat(counts, dim=1).contiguous()
    nnz = int((joined[:g, :N] != 0).sum())
    for kk in sorted({max(1, nnz // 2), max(1, nnz), 1 << nnz.bit_length()}):
        before = torch_rm.sharded_counts_pull.launches
        idx, vals = torch_rm.sharded_counts_pull(counts, g, N, compact, kk)
        torch.cuda.synchronize()
        assert torch_rm.sharded_counts_pull.launches == before + 1
        w_idx, w_vals = torch_rm.sharded_counts_pull_plain(counts, g, N,
                                                           compact, kk)
        o_idx, o_vals = torch_resident.sparse_counts_plain(joined, g, N, kk,
                                                           compact)
        assert torch.equal(idx, w_idx) and torch.equal(vals, w_vals), kk
        assert torch.equal(idx, o_idx) and torch.equal(vals, o_vals), kk
