"""The redesigned K12 (match-index commit: a warp or a block of ranks, the
quorum by value or read on the card) and K6 (counts window: a 1-D grid,
vector and scalar paths) against their plain PyTorch versions, on the
card. Every test here is marked `gpu` and skips without a CUDA device; the
file imports neither JAX nor the JAX package, so on a machine without JAX
it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_redesign.py

Outputs are integer: the tolerance is exact equality.
"""
import numpy as np
import pytest
import torch

from swarmkit_tpu_torch.ops import raft_replay as torch_replay
from swarmkit_tpu_torch.ops import resident as torch_resident

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu

INT32_MAX = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _match_indices(m, kind, seed):
    """int32[m] with ties, zeros and INT32_MAX."""
    rng = np.random.RandomState(seed)
    if kind == "spread":
        mi = rng.randint(0, INT32_MAX, size=m, dtype=np.int64)
        mi[rng.rand(m) < 0.2] = 0
        mi[rng.rand(m) < 0.1] = INT32_MAX
    elif kind == "ties":
        mi = rng.choice(np.array([0, 1, 7, 1 << 20, INT32_MAX]), size=m)
    else:                                   # every value the same
        mi = np.full(m, INT32_MAX if kind == "max" else 0)
    return mi.astype(np.int32)


def _quorum_forms(q, cuda):
    return (q, np.int32(q), np.int64(q), torch.tensor(q, dtype=torch.int32),
            torch.tensor(q, dtype=torch.int32, device=cuda))


def _match_index_against_plain(t, quorums, cuda, forms=True):
    got, want = [], []
    before = torch_replay.match_index_commit.launches
    for q in quorums:
        w = torch_replay.match_index_commit_plain(t, q)
        for f in (_quorum_forms(q, cuda) if forms else (q,)):
            r = torch_replay.match_index_commit(t, f)
            assert r.dtype == torch.int32 and r.dim() == 0
            assert r.device == t.device
            got.append(r)
            want.append(w)
    torch.cuda.synchronize()
    assert torch_replay.match_index_commit.launches == before + len(got)
    assert torch.equal(torch.stack(got), torch.stack(want))


@pytest.mark.parametrize("kind", ["spread", "ties", "max", "zeros"])
@pytest.mark.parametrize("m", [1, 2, 5, 31, 32, 33, 64, 1000, 4096])
def test_match_index_commit_every_quorum_and_form(cuda, m, kind):
    t = torch.from_numpy(_match_indices(m, kind, m)).to(cuda)
    _match_index_against_plain(t, range(-m - 1, m + 2), cuda)


@pytest.mark.parametrize("m", [8193, 20_000])
def test_match_index_commit_beyond_one_stage(cuda, m):
    # more values than the block stages in shared memory at once
    t = torch.from_numpy(_match_indices(m, "ties", m)).to(cuda)
    quorums = [-m - 1, -m, -1, 0, 1, 2, m // 3, m // 2 + 1, m - 1, m, m + 1]
    _match_index_against_plain(t, quorums, cuda)


def test_match_index_commit_one_launch_a_call(cuda):
    t = torch.from_numpy(_match_indices(5, "spread", 0)).to(cuda)
    q_dev = torch.tensor(3, dtype=torch.int32, device=cuda)
    for q in (3, np.int64(3), torch.tensor(3), q_dev):
        before = torch_replay.match_index_commit.launches
        torch_replay.match_index_commit(t, q)
        assert torch_replay.match_index_commit.launches == before + 1
    with pytest.raises(RuntimeError):
        torch_replay.match_index_commit(t, 2**31)


def _counts(seed, gp, n_pad, g, n):
    rng = np.random.RandomState(seed)
    c = rng.randint(-5, 600, (gp, n_pad)).astype(np.int32)
    c[:g, :n] = np.where(rng.rand(g, n) < 0.3, rng.randint(1, 600, (g, n)),
                         0)
    return c


def _window_against_plain(counts, g, n, compact, vector):
    before = torch_resident.counts_window.launches
    got = torch_resident.counts_window(counts, g, n, compact)
    want = torch_resident.counts_window_plain(counts, g, n, compact)
    torch.cuda.synchronize()
    assert torch_resident.counts_window.launches == before + 1
    assert torch_resident.window_vector(
        counts.data_ptr(), got.data_ptr(), n, counts.shape[1]) is vector
    assert got.dtype == want.dtype and got.is_contiguous()
    assert tuple(got.shape) == (g, n)
    assert torch.equal(got, want)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("shape,vector", [
    ((32, 16384, 20, 10000), True),          # the grid tick's dense pull
    ((32, 131072, 20, 100000), True),
    ((4, 8, 1, 4), True),
    ((8, 1024, 5, 1001), False),             # n % 4 = 1, 2, 3
    ((8, 1024, 5, 1002), False),
    ((8, 1024, 5, 1003), False),
    ((8, 1023, 5, 1000), False),             # Np % 4 != 0
    ((1, 1, 1, 1), False),
    ((70_000, 8, 70_000, 8), True),          # more groups than grid rows
    ((70_000, 8, 69_999, 7), False),
])
def test_counts_window_paths(cuda, shape, vector, compact):
    gp, n_pad, g, n = shape
    counts = torch.from_numpy(_counts(gp + n, gp, n_pad, g, n)).to(cuda)
    _window_against_plain(counts, g, n, compact, vector)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("offset", [1, 2, 3, 4])
def test_counts_window_unaligned_view(cuda, offset, compact):
    # a contiguous view whose rows start 4 * offset bytes into the storage:
    # 16-byte aligned only at offset 4
    gp, n_pad, g, n = 32, 16384, 20, 10000
    storage = torch.empty(gp * n_pad + offset, dtype=torch.int32,
                          device=cuda)
    counts = storage[offset:].view(gp, n_pad)
    counts.copy_(torch.from_numpy(_counts(offset, gp, n_pad, g, n)))
    assert counts.is_contiguous()
    _window_against_plain(counts, g, n, compact, offset == 4)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("g,n", [(0, 10000), (20, 0), (0, 0)])
def test_counts_window_empty_launches_nothing(cuda, g, n, compact):
    counts = torch.zeros((32, 16384), dtype=torch.int32, device=cuda)
    before = torch_resident.counts_window.launches
    got = torch_resident.counts_window(counts, g, n, compact)
    assert torch_resident.counts_window.launches == before
    assert tuple(got.shape) == (g, n) and got.device == counts.device
    assert got.dtype == (torch.int16 if compact else torch.int32)
