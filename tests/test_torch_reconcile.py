"""The port's reconcile functions (`swarmkit_tpu_torch.ops.reconcile`: K14-K17
and their plain PyTorch versions) against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both; the JAX functions run as
the JAX package's own tests run them (jit on the CPU). Outputs are bool,
uint8 or int32: the tolerance is exact equality. The seeds and shapes of
the JAX package's `tests/test_reconcile_kernel.py` come first, then the
edges of the reference's integer rules.
"""
import numpy as np
import pytest
import torch

from swarmkit_tpu.ops import reconcile as jax_rec
from swarmkit_tpu_torch.ops import reconcile as torch_rec

torch.set_num_threads(1)

# the probe cluster of the reference's integer rules: N = 4
ELIG = np.array([[1, 0, 1, 0], [0, 1, 1, 1]], bool)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor)
                                  else got, np.asarray(want))


def _updates(rng, S, T, U, N):
    flat = rng.choice(S * T, U, replace=False)
    return ((flat // T).astype(np.int32), (flat % T).astype(np.int32),
            rng.integers(-1, N, U).astype(np.int32))


# ------------------------------------------------------------- K14 diff
def test_global_diff_matches_jax_on_the_reference_inputs():
    rng = np.random.default_rng(0)          # test_kernel_matches_numpy
    for _ in range(5):
        S, N, T = rng.integers(1, 20), rng.integers(1, 50), rng.integers(1, 30)
        eligible = rng.random((S, N)) < 0.6
        task_nodes = rng.integers(-1, N, (S, T)).astype(np.int32)
        c_j, s_j = jax_rec.global_diff(eligible, task_nodes)
        c_t, s_t = torch_rec.global_diff(_t(eligible), _t(task_nodes))
        _eq(c_t, c_j)
        _eq(s_t, s_j)
        c_n, s_n = torch_rec.global_diff_np(eligible, task_nodes)
        _eq(c_n, c_j)
        _eq(s_n, s_j)


@pytest.mark.parametrize("task_nodes", [
    [[0, 5, -1], [3, -1, -1]],              # an id past the last node
    [[-1, -1, -1], [-1, -1, -1]],           # all padding
    [[4, 4, 2], [7, 0, -3]],                # ids >= N and < -1
], ids=["past_last", "all_pad", "mixed"])
def test_global_diff_clips_ids_past_the_last_node(task_nodes):
    tn = np.array(task_nodes, np.int32)
    c_j, s_j = jax_rec.global_diff(ELIG, tn)
    c_t, s_t = torch_rec.global_diff(_t(ELIG), _t(tn))
    _eq(c_t, c_j)
    _eq(s_t, s_j)
    if tn[0, 1] == 5:
        assert bool(s_t[0, 3])               # node 5 counts as node 3
    if tn.max() >= ELIG.shape[1]:
        # the reference's numpy mirror indexes out of range; so does the
        # port's copy of it
        for mirror in (jax_rec.global_diff_np, torch_rec.global_diff_np):
            with pytest.raises(IndexError):
                mirror(ELIG, tn)


def test_global_diff_update_matches_jax_and_leaves_its_input():
    rng = np.random.default_rng(7)
    S, N, T, U = 9, 120, 14, 25
    eligible = rng.random((S, N)) < 0.3
    task_nodes = rng.integers(-1, N + 3, (S, T)).astype(np.int32)
    tn_t = _t(task_nodes.copy())
    for _ in range(3):
        r, c, v = _updates(rng, S, T, U, N + 2)
        want = jax_rec.global_diff_update(eligible, task_nodes, r, c, v)
        got = torch_rec.global_diff_update(_t(eligible), tn_t, r, c, v)
        for g, w in zip(got, want):
            _eq(g, w)
        _eq(tn_t, task_nodes)                # the input is left as it was
        task_nodes = np.asarray(want[0])
        tn_t = got[0]


@pytest.mark.parametrize("cap", [0, 1, 2, 3, 4, 5, 64])
def test_global_diff_update_compact_matches_jax(cap):
    """The reference's probe: slot (0, 0) set to 1 gives 4 creates and 2
    shutdowns; cap below, at and above both counts."""
    tn = np.array([[0, 5, -1], [3, -1, -1]], np.int32)
    r, c, v = (np.array([0], np.int32), np.array([0], np.int32),
               np.array([1], np.int32))
    want = jax_rec.global_diff_update_compact(ELIG, tn, r, c, v, cap=cap)
    got = torch_rec.global_diff_update_compact(_t(ELIG), _t(tn), r, c, v, cap)
    for g, w in zip(got, want):
        _eq(g, w)
    assert got[1].dtype == got[2].dtype == got[3].dtype == torch.int32
    assert (int(got[3]), int(got[4])) == (4, 2)
    if cap == 2:
        _eq(got[1], [[0, 0], [0, 2]])
        _eq(got[2], [[0, 1], [0, 3]])


def test_global_diff_update_compact_random_matches_jax():
    rng = np.random.default_rng(11)
    S, N, T, U = 6, 70, 10, 12
    eligible = rng.random((S, N)) < 0.4
    task_nodes = rng.integers(-1, N, (S, T)).astype(np.int32)
    r, c, v = _updates(rng, S, T, U, N)
    for cap in (5, 2 * U, 400):
        want = jax_rec.global_diff_update_compact(eligible, task_nodes, r, c,
                                                  v, cap=cap)
        got = torch_rec.global_diff_update_compact(_t(eligible),
                                                   _t(task_nodes), r, c, v,
                                                   cap)
        for g, w in zip(got, want):
            _eq(g, w)


def test_diff_compact_equals_nonzero_cut_to_cap():
    rng = np.random.default_rng(12)
    mask = rng.random((7, 33)) < 0.2
    hits = np.stack(np.nonzero(mask), 1).astype(np.int32)
    for cap in (0, 1, len(hits) - 1, len(hits), len(hits) + 9):
        idx, count = torch_rec.diff_compact(_t(mask), cap)
        want = np.full((cap, 2), -1, np.int32)
        k = min(cap, len(hits))
        want[:k] = hits[:k]
        _eq(idx, want)
        assert int(count) == len(hits)
    idx, count = torch_rec.diff_compact(torch.zeros((0, 5), dtype=torch.bool),
                                        3)
    _eq(idx, np.full((3, 2), -1, np.int32))
    assert int(count) == 0


# ------------------------------------------------------------ K16 counts
@pytest.mark.parametrize("case", ["random", "past_last", "all_pad"])
def test_task_count_flat_matches_jax(case):
    rng = np.random.default_rng(3)
    S, N, T = 10, 40, 17
    tn = rng.integers(-1, N, (S, T)).astype(np.int32)
    if case == "past_last":
        tn[rng.random((S, T)) < 0.2] = N + 5
    elif case == "all_pad":
        tn[:] = -1
    want = jax_rec.task_count_flat(tn, N)
    got = torch_rec.task_count_flat(_t(tn), N)
    assert got.dtype == torch.int32
    _eq(got, want)


# ------------------------------------------------------------ K17 churn
def _full_counts(tn, S, N):
    exp = np.zeros(S * N, np.int32)
    for si in range(S):
        v = tn[si][tn[si] >= 0]
        np.add.at(exp, si * N + v, 1)
    return exp


def test_churn_matches_jax_over_the_reference_trace():
    """test_churn_kernel_matches_numpy_over_trace: rng(42), S12 N300 T20
    U30, 10 rounds; every output equal to the JAX round's, the carry to the
    full recount, the valid decisions to the full diff."""
    rng = np.random.default_rng(42)
    S, N, T, U = 12, 300, 20, 30
    eligible = rng.random((S, N)) < 0.25
    task_nodes = rng.integers(-1, N, (S, T)).astype(np.int32)
    tn = task_nodes.copy()
    tn_j, cnt_j = task_nodes, jax_rec.task_count_flat(task_nodes, N)
    tn_t = _t(task_nodes)
    cnt_t = torch_rec.task_count_flat(tn_t, N)
    elig_t = _t(eligible)
    for rnd in range(10):
        rows, cols, vals = _updates(rng, S, T, U, N)
        want = jax_rec.global_diff_churn(eligible, tn_j, cnt_j, rows, cols,
                                         vals)
        before = cnt_t.clone()
        got = torch_rec.global_diff_churn(elig_t, tn_t, cnt_t, rows, cols,
                                          vals)
        assert torch.equal(cnt_t, before)    # the input carry is left
        for g, w in zip(got, want):
            _eq(g, w)
        tn[rows, cols] = vals
        _eq(got[1], _full_counts(tn, S, N))
        c_np, s_np = jax_rec.global_diff_np(eligible, tn)
        pairs, cre, shut, valid = (x.numpy() for x in got[2:])
        for (s, n), cb, sb, v in zip(pairs, cre, shut, valid):
            if v:
                assert (c_np[s, n], s_np[s, n]) == (cb, sb), (rnd, s, n)
        tn_j, cnt_j = want[0], want[1]
        tn_t, cnt_t = got[0], got[1]


def test_churn_burst_matches_jax():
    """test_churn_burst_equals_sequential_steps: rng(5), S8 N200 T16 U20
    B6; the burst's codes equal JAX's and the rounds of the one-round
    form."""
    rng = np.random.default_rng(5)
    S, N, T, U, B = 8, 200, 16, 20, 6
    eligible = rng.random((S, N)) < 0.3
    task_nodes = rng.integers(-1, N, (S, T)).astype(np.int32)
    cnt0 = jax_rec.task_count_flat(task_nodes, N)
    flat = np.stack([rng.choice(S * T, U, replace=False) for _ in range(B)])
    rows_b = (flat // T).astype(np.int32)
    cols_b = (flat % T).astype(np.int32)
    vals_b = rng.integers(-1, N, (B, U)).astype(np.int32)
    want = jax_rec.global_diff_churn_burst(eligible, task_nodes, cnt0,
                                           rows_b, cols_b, vals_b)
    tn_t, cnt_t, elig_t = _t(task_nodes), _t(np.asarray(cnt0)), _t(eligible)
    got = torch_rec.global_diff_churn_burst(elig_t, tn_t, cnt_t, rows_b,
                                            cols_b, vals_b)
    assert got[2].dtype == torch.uint8 and tuple(got[2].shape) == (B, 2 * U)
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(tn_t, task_nodes)
    _eq(cnt_t, cnt0)
    for b in range(B):
        tn_t, cnt_t, _, cre, shut, valid = torch_rec.global_diff_churn(
            elig_t, tn_t, cnt_t, rows_b[b], cols_b[b], vals_b[b])
        _eq(got[2][b], torch_rec._codes(cre, shut, valid))


def test_churn_value_equal_to_n_follows_jax():
    """The reference's probe: slot (0, 2) from -1 to N lands in the count
    of (1, 0); the pair is (0, 4), valid, and a shutdown (its eligibility
    gather clamps to node 3, its count gather reads cell 4)."""
    tn = np.array([[0, 1, -1], [3, -1, -1]], np.int32)
    cnt = jax_rec.task_count_flat(tn, 4)
    _eq(torch_rec.task_count_flat(_t(tn), 4), [1, 1, 0, 0, 0, 0, 0, 1])
    r, c, v = (np.array([0], np.int32), np.array([2], np.int32),
               np.array([4], np.int32))
    want = jax_rec.global_diff_churn(ELIG, tn, cnt, r, c, v)
    got = torch_rec.global_diff_churn(_t(ELIG), _t(tn), _t(np.asarray(cnt)),
                                      r, c, v)
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(got[1], [1, 1, 0, 0, 1, 0, 0, 1])
    _eq(got[2], [[0, 0], [0, 4]])
    _eq(got[5], [False, True])
    _eq(got[4], [False, True])


@pytest.mark.parametrize("case", ["all_pad", "old_eq_new", "dup_old_nodes",
                                  "past_last", "last_row_value_n"])
def test_churn_edges_follow_jax(case):
    rng = np.random.default_rng(9)
    S, N, T, U, B = 5, 30, 8, 6, 3
    eligible = rng.random((S, N)) < 0.5
    tn = rng.integers(-1, N, (S, T)).astype(np.int32)
    flat = np.stack([rng.choice(S * T, U, replace=False) for _ in range(B)])
    rows_b = (flat // T).astype(np.int32)
    cols_b = (flat % T).astype(np.int32)
    vals_b = rng.integers(-1, N, (B, U)).astype(np.int32)
    if case == "all_pad":
        tn[:] = -1
        vals_b[:] = -1
    elif case == "old_eq_new":
        vals_b[0] = tn[rows_b[0], cols_b[0]]
    elif case == "dup_old_nodes":
        # every slot of row 0 on node 2, then moved away in one round
        tn[0] = 2
        rows_b[0] = 0
        cols_b[0] = np.arange(U)
    elif case == "past_last":
        vals_b[1, :3] = N
        vals_b[2, :2] = N + 7
    elif case == "last_row_value_n":
        rows_b[:, 0] = S - 1
        cols_b[:, 0] = np.arange(B)
        vals_b[:, 0] = N                     # an add past S * N: dropped
        vals_b[:, 1:] = np.where(rows_b[:, 1:] == S - 1, -1, vals_b[:, 1:])
    if case == "last_row_value_n":
        # keep the triples' slots unique after the edit
        keep = [np.unique(rows_b[b] * T + cols_b[b]).size == U
                for b in range(B)]
        assert all(keep)
    cnt0 = jax_rec.task_count_flat(tn, N)
    want = jax_rec.global_diff_churn_burst(eligible, tn, cnt0, rows_b,
                                           cols_b, vals_b)
    got = torch_rec.global_diff_churn_burst(_t(eligible), _t(tn),
                                            _t(np.asarray(cnt0)), rows_b,
                                            cols_b, vals_b)
    for g, w in zip(got, want):
        _eq(g, w)
    one = jax_rec.global_diff_churn(eligible, tn, cnt0, rows_b[0], cols_b[0],
                                    vals_b[0])
    got1 = torch_rec.global_diff_churn(_t(eligible), _t(tn),
                                       _t(np.asarray(cnt0)), rows_b[0],
                                       cols_b[0], vals_b[0])
    for g, w in zip(got1, one):
        _eq(g, w)


# ------------------------------------------------------- the int32 limit
def test_flat_index_past_2_31_is_refused():
    """The reference's flat int32 keys wrap silently from 2^31; the port's
    wrappers (kernel and plain alike) raise first. Shown on meta tensors
    and shapes that would never be allocated."""
    big = (1 << 16, 1 << 15)                 # S * N = 2^31
    tn = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^31"):
        torch_rec.task_count_flat(tn, 1 << 30)
    with pytest.raises(ValueError, match="2\\^31"):
        torch_rec.task_count_flat(tn.to("meta"), 1 << 30)
    mask = torch.empty(big, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        torch_rec.diff_compact(mask, 4)
    tn_big = torch.empty((big[0], 1), dtype=torch.int32, device="meta")
    cnt = torch.empty(big[0] * big[1], dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        torch_rec.global_diff_churn_burst(
            mask, tn_big, cnt, np.zeros((1, 1), np.int32),
            np.zeros((1, 1), np.int32), np.zeros((1, 1), np.int32))
    with pytest.raises(ValueError, match="2\\^31"):
        torch_rec.global_diff_update_compact(
            mask, tn_big, np.zeros(1, np.int32), np.zeros(1, np.int32),
            np.zeros(1, np.int32), 4)
    # S * N below 2^31, but row * N + value at it
    tn = np.array([[0, 1, -1], [3, -1, -1]], np.int32)
    cnt = torch_rec.task_count_flat(_t(tn), 4)
    with pytest.raises(ValueError, match="2\\^31"):
        torch_rec.global_diff_churn(
            _t(ELIG), _t(tn), cnt, np.array([1], np.int32),
            np.array([1], np.int32), np.array([(1 << 31) - 4], np.int32))


def test_update_triples_outside_the_table_are_refused():
    tn = _t(np.array([[0, 1, -1], [3, -1, -1]], np.int32))
    cnt = torch_rec.task_count_flat(tn, 4)
    one = np.array([0], np.int32)
    for r, c in ((2, 0), (-1, 0), (0, 3), (0, -1)):
        rr, cc = np.array([r], np.int32), np.array([c], np.int32)
        with pytest.raises(ValueError, match="outside"):
            torch_rec.global_diff_update(_t(ELIG), tn, rr, cc, one)
        with pytest.raises(ValueError, match="outside"):
            torch_rec.global_diff_churn(_t(ELIG), tn, cnt, rr, cc, one)
    with pytest.raises(ValueError, match="equal shapes"):
        torch_rec.global_diff_churn_burst(_t(ELIG), tn, cnt, one, one, one)


def test_update_triples_in_any_host_form():
    """Triples given as int32 arrays, int64 arrays, CPU tensors or lists
    give the same results."""
    tn = _t(np.array([[0, 1, -1], [3, -1, -1]], np.int32))
    cnt = torch_rec.task_count_flat(tn, 4)
    r, c, v = [1, 0], [1, 2], [2, 4]
    want = torch_rec.global_diff_churn(
        _t(ELIG), tn, cnt, *(np.array(x, np.int32) for x in (r, c, v)))
    for form in (lambda x: np.array(x, np.int64), lambda x: x,
                 lambda x: torch.tensor(x, dtype=torch.int32)):
        got = torch_rec.global_diff_churn(_t(ELIG), tn, cnt,
                                          *(form(x) for x in (r, c, v)))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        got = torch_rec.global_diff_update(_t(ELIG), tn,
                                           *(form(x) for x in (r, c, v)))
        assert torch.equal(got[0], want[0])


# ------------------------------------------------------ compute_diff
@pytest.mark.parametrize("branch", ["numpy", "kernel"])
def test_compute_diff_branches_equal_jax(branch, monkeypatch):
    """Both branches of the dispatch, by moving the threshold in the port's
    module only: below it numpy, at or above it the kernel's route (the
    plain version on the CPU)."""
    rng = np.random.default_rng(4)
    eligible = rng.random((6, 50)) < 0.5
    tn = rng.integers(-1, 50, (6, 9)).astype(np.int32)
    calls = []
    real = torch_rec.global_diff_plain
    monkeypatch.setattr(torch_rec, "global_diff_plain",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(torch_rec, "DIFF_THRESHOLD",
                        300 if branch == "kernel" else 301)
    got = torch_rec.compute_diff(eligible, tn, device="cpu")
    want = jax_rec.compute_diff(eligible, tn)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        _eq(g, w)
    assert len(calls) == (1 if branch == "kernel" else 0)


def test_compute_diff_kernel_branch_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch_rec, "DIFF_THRESHOLD", 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_rec.compute_diff(ELIG, np.array([[0], [1]], np.int32))
    # below the threshold numpy runs, whatever the device
    monkeypatch.setattr(torch_rec, "DIFF_THRESHOLD", 9)
    torch_rec.compute_diff(ELIG, np.array([[0], [1]], np.int32))


# --------------------------------------------------- cold eligibility
@pytest.mark.parametrize("s,n", [(1, 1), (3, 8), (5, 13), (20, 1001)])
def test_pack_unpack_eligibility_round_trip(s, n):
    eligible = np.random.default_rng(s * n).random((s, n)) < 0.3
    packed = torch_rec.pack_eligibility(eligible)
    _eq(packed, jax_rec.pack_eligibility(eligible))
    got = torch_rec.unpack_eligibility(_t(packed), n)
    _eq(got, eligible)
    _eq(got, jax_rec.unpack_eligibility(packed, n))
