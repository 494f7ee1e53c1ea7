"""The port's raft replay (plain PyTorch on the CPU) against the JAX
reference: `replay_commit`, `frontier_advance`, `frontier_advance_burst`,
`match_index_commit` and `replay_log_scan`, on the reference's own test
inputs (tests/test_parallel.py, tests/test_reconcile_kernel.py,
tests/test_raft_group_commit.py) and on edges they leave out. Every output
is an integer or a bool, so the tolerance is exact equality. The kernels
K4 and K10-K13 are held against these plain versions on the card
(tests/test_torch_gpu.py, tests/test_torch_gpu_replay.py)."""
import random

import numpy as np
import pytest
import torch

from swarmkit_tpu.ops import raft_replay as jax_replay
from swarmkit_tpu_torch import convert
from swarmkit_tpu_torch.ops import raft_replay as torch_replay

torch.set_num_threads(1)


def assert_replay_parity(acks: np.ndarray, quorum: int) -> int:
    want_commit, want_committed = jax_replay.replay_commit(acks, quorum)
    a, q = convert.acks_from_numpy(acks, np.int32(quorum), "cpu")
    commit, committed = torch_replay.replay_commit(a, q)
    assert commit.dtype == torch.int32 and commit.dim() == 0
    assert committed.dtype == torch.bool
    assert int(commit) == int(want_commit)
    np.testing.assert_array_equal(committed.numpy(),
                                  np.asarray(want_committed))
    # the commit rule itself: the longest prefix with tally >= quorum
    ok = acks.sum(axis=0) >= quorum
    expect = int(np.argmin(ok)) if not ok.all() else acks.shape[1]
    assert int(commit) == expect
    return int(commit)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("m", [1, 3, 5, 7])
def test_replay_commit_random_matches_jax(seed, m):
    rng = np.random.RandomState(seed)
    E = int(rng.randint(1, 4000))
    # high ack rates so the committed prefix is long and varied
    acks = rng.rand(m, E) < rng.uniform(0.85, 0.999)
    assert_replay_parity(acks, m // 2 + 1)


@pytest.mark.parametrize("m", [1, 5])
def test_replay_commit_edge_cases(m):
    E = 257
    none = np.zeros((m, E), bool)
    assert assert_replay_parity(none, m // 2 + 1) == 0
    full = np.ones((m, E), bool)
    assert assert_replay_parity(full, m // 2 + 1) == E
    first_short = full.copy()
    first_short[:, 0] = False
    assert assert_replay_parity(first_short, m // 2 + 1) == 0
    last_short = full.copy()
    last_short[:, -1] = False
    assert assert_replay_parity(last_short, m // 2 + 1) == E - 1
    # quorum = M: one missing ack anywhere stops the prefix there
    one_missing = full.copy()
    one_missing[m - 1, 100] = False
    assert assert_replay_parity(one_missing, m) == 100


def test_replay_commit_python_int_quorum():
    acks = np.random.RandomState(0).rand(5, 300) < 0.9
    commit, committed = torch_replay.replay_commit(torch.from_numpy(acks), 3)
    want, _ = jax_replay.replay_commit(acks, 3)
    assert int(commit) == int(want)
    assert int(committed.sum()) == int(want)


# ------------------------------------------------------- frontier advance
def test_frontier_advance_matches_jax_sequence():
    """tests/test_reconcile_kernel.py::test_frontier_advance_matches_replay:
    six rounds on a resident 5 x 5,000 matrix, each against the JAX step,
    the JAX replay of the numpy matrix and that matrix itself."""
    rng = np.random.default_rng(3)
    M, E = 5, 5_000
    acks = np.zeros((M, E), bool)
    dev = torch.from_numpy(acks.copy())
    jdev = acks.copy()
    f = np.zeros(M, np.int32)
    for _ in range(6):
        f = np.minimum(f + rng.integers(0, 500, M).astype(np.int32), E - 1)
        dev, commit = torch_replay.frontier_advance(dev, f, 3)
        jdev, jcommit = jax_replay.frontier_advance(jdev, f, 3)
        for m in range(M):
            acks[m, :f[m]] = True
        exp_commit, _ = jax_replay.replay_commit(acks, 3)
        assert commit.dtype == torch.int32 and commit.dim() == 0
        assert int(commit) == int(jcommit) == int(exp_commit)
        np.testing.assert_array_equal(dev.numpy(), np.asarray(jdev))
        np.testing.assert_array_equal(dev.numpy(), acks)


def _frontiers(rng, B, M, E, kind):
    if kind == "random":       # negative, inside and beyond E, unordered
        return rng.randint(-E // 4 - 2, E + E // 4 + 3,
                           size=(B, M)).astype(np.int32)
    if kind == "decreasing":   # later rounds lower: the OR keeps the max
        top = rng.randint(0, E + 3, size=M)
        return np.stack([top - 37 * b for b in range(B)]).astype(np.int32)
    base = rng.randint(-3, E // 2 + 1, size=M)   # "rising", as bench.py
    return np.stack([np.minimum(base + rng.randint(0, E // 8 + 1, M) * b,
                                E - 1) for b in range(B)]).astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "decreasing", "rising"])
@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("m,e", [(1, 13), (3, 1003), (5, 4099)])
def test_frontier_advance_burst_matches_jax(kind, B, m, e):
    rng = np.random.RandomState(B * 1000 + m * 10 + len(kind))
    acks = rng.rand(m, e) < 0.3
    fronts = _frontiers(rng, B, m, e, kind)
    for quorum in (0, 1, m // 2 + 1, m, m + 1):
        got_acks, got = torch_replay.frontier_advance_burst(
            torch.from_numpy(acks), fronts, quorum)
        want_acks, want = jax_replay.frontier_advance_burst(acks, fronts,
                                                            quorum)
        assert got.dtype == torch.int32 and tuple(got.shape) == (B,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_acks.numpy(),
                                      np.asarray(want_acks))
    # the input stays as it was, as the reference's does
    np.testing.assert_array_equal(torch.from_numpy(acks).numpy(), acks)


def test_frontier_advance_burst_refuses_bad_frontiers():
    acks = torch.zeros((3, 16), dtype=torch.bool)
    with pytest.raises(ValueError, match="frontiers_b"):
        torch_replay.frontier_advance_burst(acks, np.zeros((2, 4), np.int32),
                                            2)
    with pytest.raises(ValueError, match="meta"):
        torch_replay.frontier_advance_burst(acks.to("meta"),
                                            np.zeros((2, 3), np.int32), 2)


# ------------------------------------------------------ match-index commit
def test_match_index_commit_reference_case():
    """tests/test_parallel.py::test_match_index_commit."""
    mi = np.array([100, 90, 80, 70, 60], np.int32)
    got = torch_replay.match_index_commit(torch.from_numpy(mi), 3)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(jax_replay.match_index_commit(mi, 3)) == 80


def _raft_cases():
    """tests/test_raft_group_commit.py's 60 fuzzed cases (seed 20250803):
    (M, prefix-contiguous frontiers, quorum)."""
    rng = random.Random(20250803)
    cases = []
    for _ in range(60):
        m = rng.choice([1, 2, 3, 4, 5, 7])
        e_max = rng.randrange(1, 32)
        frontiers = [e_max] + [rng.randrange(0, e_max + 1)
                               for _ in range(m - 1)]
        cases.append((m, e_max, frontiers, m // 2 + 1))
    return cases


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 7])
def test_match_index_commit_fuzzed_raft_cases(m):
    """The fuzzed cases of one manager count: the port equals JAX's
    match_index_commit, and on prefix-contiguous acks both replays."""
    cases = [c for c in _raft_cases() if c[0] == m]
    assert cases
    for _m, e_max, frontiers, quorum in cases:
        acks = np.zeros((m, e_max), bool)
        for i, f in enumerate(frontiers):
            acks[i, :f] = True
        mi = np.asarray(frontiers, np.int32)
        got = int(torch_replay.match_index_commit(torch.from_numpy(mi),
                                                  quorum))
        assert got == int(jax_replay.match_index_commit(mi, quorum))
        assert got == int(torch_replay.replay_commit(
            torch.from_numpy(acks), quorum)[0])
        assert got == int(jax_replay.replay_commit(acks, quorum)[0])


@pytest.mark.parametrize("m", [1, 2, 5, 7, 64])
def test_match_index_commit_quorum_edges(m):
    """Every quorum in [0, M + 1] (and below 0), on match indices across
    [0, 2^31 - 1] with ties: the reference's indexing wraps a negative index
    once and clamps the rest."""
    rng = np.random.RandomState(m)
    mi = rng.randint(0, 2**31 - 1, size=m, dtype=np.int64).astype(np.int32)
    mi[rng.rand(m) < 0.2] = 2**31 - 1
    mi[rng.rand(m) < 0.2] = 0
    if m > 2:
        mi[1] = mi[2]                     # a tie
    t = torch.from_numpy(mi)
    for quorum in range(-m - 2, m + 2):
        want = int(jax_replay.match_index_commit(mi, quorum))
        assert int(torch_replay.match_index_commit(t, quorum)) == want
        assert int(torch_replay.match_index_commit(
            t, torch.tensor(quorum, dtype=torch.int32))) == want
    assert int(torch_replay.match_index_commit(t, 0)) == int(mi.min())
    assert int(torch_replay.match_index_commit(t, m + 1)) == int(mi.min())
    assert int(torch_replay.match_index_commit(t, 1)) == int(mi.max())


def test_match_index_commit_refuses_bad_input():
    with pytest.raises(ValueError, match="no managers"):
        torch_replay.match_index_commit(torch.zeros(0, dtype=torch.int32), 1)
    with pytest.raises(TypeError, match="int32"):
        torch_replay.match_index_commit(torch.zeros(3, dtype=torch.int64), 1)


# ------------------------------------------------------- streaming scan
@pytest.mark.parametrize("seed", range(5))
def test_replay_log_scan_reference_case(seed):
    """tests/test_parallel.py::test_replay_commit_matches_reference: 5 x
    1,000 with the leader acking every entry, chunk 128 (a tail of 104)."""
    rng = np.random.RandomState(seed)
    acks = rng.rand(5, 1000) < 0.8
    acks[0] = True
    got = torch_replay.replay_log_scan(torch.from_numpy(acks), 3, chunk=128)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(jax_replay.replay_log_scan(acks, 3, chunk=128))
    assert int(got) == int(jax_replay.replay_commit(acks, 3)[0])


@pytest.mark.parametrize("e", [1, 100, 128, 384, 385, 1000, 1024])
@pytest.mark.parametrize("m", [1, 5])
def test_replay_log_scan_chunk_shapes(e, m):
    """E < chunk, E = k * chunk and E = k * chunk + r at chunk 128 (and one
    chunk larger than E), with long committed prefixes, against JAX."""
    rng = np.random.RandomState(e * 7 + m)
    acks = rng.rand(m, e) < 0.995
    a = torch.from_numpy(acks)
    for quorum in (0, 1, m // 2 + 1, m, m + 1):
        want = int(jax_replay.replay_commit(acks, quorum)[0])
        for chunk in (128, 4096):
            assert int(torch_replay.replay_log_scan(a, quorum, chunk)) \
                == int(jax_replay.replay_log_scan(acks, quorum, chunk=chunk)) \
                == want
    full = torch.ones((m, e), dtype=torch.bool)
    assert int(torch_replay.replay_log_scan(full, m, 128)) == e


def test_replay_log_scan_refuses_bad_chunk():
    with pytest.raises(ValueError, match="chunk"):
        torch_replay.replay_log_scan(torch.ones((2, 8), dtype=torch.bool),
                                     1, 0)
