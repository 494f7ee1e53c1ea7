"""The raft replay kernels K10-K13 against their plain PyTorch versions, on
the card. Every test here is marked `gpu` and skips without a CUDA device;
the file imports neither JAX nor the JAX package, so on a machine without
JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_replay.py

Outputs are integer or bool: the tolerance is exact equality.
"""
import numpy as np
import pytest
import torch

from swarmkit_tpu_torch.ops import bitpack as torch_bitpack
from swarmkit_tpu_torch.ops import raft_replay as torch_replay

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _launched(fn, wrapper):
    before = wrapper.launches
    out = fn()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    return out


@pytest.mark.parametrize("r,c", [(1, 1), (5, 13), (3, 1000), (5, 1_000_000),
                                 (70_000, 9)])
def test_unpack_bits_kernel_matches_plain(cuda, r, c):
    rows = np.random.RandomState(r + c).rand(r, c) < 0.5
    packed = torch.from_numpy(torch_bitpack.pack_bits(rows)).to(cuda)
    got = _launched(lambda: torch_bitpack.unpack_bits(packed, c),
                    torch_bitpack.unpack_bits)
    assert got.dtype == torch.bool and tuple(got.shape) == (r, c)
    assert torch.equal(got, torch_bitpack.unpack_bits_plain(packed, c))
    np.testing.assert_array_equal(got.cpu().numpy(), rows)
    with pytest.raises(ValueError, match="cannot hold"):
        torch_bitpack.unpack_bits(packed, 8 * packed.shape[1] + 1)


@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("m,e", [(1, 13), (5, 4099), (5, 1_000_000)])
def test_frontier_advance_burst_kernel_matches_plain(cuda, B, m, e):
    rng = np.random.RandomState(B * 10 + m)
    acks = torch.from_numpy(rng.rand(m, e) < 0.3).to(cuda)
    fronts = torch.from_numpy(rng.randint(-e // 4, e + e // 4 + 2,
                                          size=(B, m)).astype(np.int32))
    for quorum in (0, 1, m // 2 + 1, m, m + 1):
        got_acks, got = _launched(
            lambda: torch_replay.frontier_advance_burst(acks, fronts, quorum),
            torch_replay.frontier_advance_burst)
        want_acks, want = torch_replay.frontier_advance_burst_plain(
            acks, fronts.to(cuda), quorum)
        assert torch.equal(got, want) and torch.equal(got_acks, want_acks)
    one_acks, one = torch_replay.frontier_advance(acks, fronts[0], m // 2 + 1)
    w_acks, w = torch_replay.frontier_advance_burst_plain(
        acks, fronts[:1].to(cuda), m // 2 + 1)
    assert int(one) == int(w[0]) and torch.equal(one_acks, w_acks)


@pytest.mark.parametrize("m", [1, 3, 5, 7, 64, 1000])
def test_match_index_commit_kernel_matches_plain(cuda, m):
    rng = np.random.RandomState(m)
    mi = rng.randint(0, 2**31 - 1, size=m, dtype=np.int64).astype(np.int32)
    mi[rng.rand(m) < 0.2] = 0
    t = torch.from_numpy(mi).to(cuda)
    for quorum in range(-m - 1, m + 2):
        got = _launched(lambda: torch_replay.match_index_commit(t, quorum),
                        torch_replay.match_index_commit)
        want = torch_replay.match_index_commit_plain(t, quorum)
        assert int(got) == int(want)
        if 1 <= quorum <= m:
            assert int(got) == int(torch.kthvalue(t.cpu(), m - quorum + 1)
                                   .values)


@pytest.mark.parametrize("chunk", [128, 65_536])
@pytest.mark.parametrize("m,e", [(1, 1), (5, 1000), (5, 1 << 17),
                                 (5, 1_000_000), (5, 1 << 20)])
def test_replay_log_scan_kernel_matches_plain(cuda, chunk, m, e):
    g = torch.Generator(device="cpu").manual_seed(m * 7 + e)
    acks = (torch.rand((m, e), generator=g) < 0.9999).to(cuda)
    full = torch.ones((m, e), dtype=torch.bool, device=cuda)
    for a in (acks, full):
        for quorum in (0, 1, m // 2 + 1, m, m + 1):
            got = _launched(
                lambda: torch_replay.replay_log_scan(a, quorum, chunk),
                torch_replay.replay_log_scan)
            want = torch_replay.replay_log_scan_plain(a, quorum, chunk)
            assert int(got) == int(want)
            assert int(got) == int(torch_replay.replay_commit_plain(
                a, torch.tensor(quorum, dtype=torch.int32, device=cuda))[0])
