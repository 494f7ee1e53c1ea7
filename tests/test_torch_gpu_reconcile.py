"""The global-reconcile kernels K14-K17 against their plain PyTorch versions,
on the card, at test sizes and at the device-resident diff's own shape (200
services x 50,000 nodes, 2,000 task slots, 1% churn a round, bursts of 16).
Every test here is marked `gpu` and skips without a CUDA device; the file
imports neither JAX nor the JAX package, so on a machine without JAX it runs
as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_reconcile.py

Outputs are bool, uint8 or int32: the tolerance is exact equality.
"""
import numpy as np
import pytest
import torch

from swarmkit_tpu_torch.ops import reconcile as rec

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu

BENCH = (200, 50_000, 2_000)        # S, N, T of the resident diff


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _launched(fn, wrapper, n=1):
    before = wrapper.launches
    out = fn()
    torch.cuda.synchronize()
    assert wrapper.launches == before + n
    return out


def _problem(S, N, T, seed, p=0.3, hi=None):
    rng = np.random.default_rng(seed)
    eligible = rng.random((S, N)) < p
    tn = rng.integers(-1, N if hi is None else hi, (S, T)).astype(np.int32)
    return rng, eligible, tn


def _converged(S, N, T, seed=0):
    """The resident diff's start (bench.py's global-diff row): every
    service's tasks on its first eligible nodes."""
    rng = np.random.default_rng(seed)
    eligible = rng.random((S, N)) < 0.04
    tn = np.full((S, T), -1, np.int32)
    for si in range(S):
        nodes = np.flatnonzero(eligible[si])[:T]
        tn[si, :nodes.size] = nodes
    return rng, eligible, tn


def _burst(rng, S, T, U, B, N):
    flat = np.stack([rng.choice(S * T, U, replace=False) for _ in range(B)])
    return ((flat // T).astype(np.int32), (flat % T).astype(np.int32),
            rng.integers(-1, N, (B, U)).astype(np.int32))


def _dev(cuda, *arrays):
    return [torch.from_numpy(np.array(a)).to(cuda) for a in arrays]


@pytest.mark.parametrize("S,N,T", [(1, 1, 1), (2, 4, 3), (7, 33, 5),
                                   (20, 50_500, 2_600), BENCH])
def test_global_diff_kernel_matches_plain(cuda, S, N, T):
    rng, eligible, tn = _problem(S, N, T, S + N, hi=N + 2)
    e, t = _dev(cuda, eligible, tn)
    got = _launched(lambda: rec.global_diff(e, t), rec.global_diff)
    want = rec.global_diff_plain(e, t)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # an unaligned view takes the byte pass
    e1, t1 = e[:, 1:].contiguous(), t
    if N > 1:
        off = torch.empty(S * (N - 1) + 1, dtype=torch.bool,
                          device=cuda)[1:].view(S, N - 1)
        off.copy_(e1)
        got = _launched(lambda: rec.global_diff(off, t1), rec.global_diff)
        for g, w in zip(got, rec.global_diff_plain(e1, t1)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("S,N,T,U", [(2, 4, 3, 1), (9, 120, 14, 25),
                                     (BENCH[0], BENCH[1], BENCH[2], 4_000)])
def test_global_diff_update_kernel_matches_plain(cuda, S, N, T, U):
    rng, eligible, tn = _problem(S, N, T, U)
    e, t = _dev(cuda, eligible, tn)
    flat = rng.choice(S * T, U, replace=False)
    r, c = (flat // T).astype(np.int32), (flat % T).astype(np.int32)
    v = rng.integers(-1, N + 1, U).astype(np.int32)
    keep = t.clone()
    got = _launched(lambda: rec.global_diff_update(e, t, r, c, v),
                    rec.global_diff)
    assert torch.equal(t, keep)             # the input is left as it was
    plain = rec.global_diff_update(e.cpu(), t.cpu(), r, c, v)
    for g, w in zip(got, plain):
        assert torch.equal(g.cpu(), w)
    for cap in (0, 3, 2 * U, S * N):
        got = _launched(
            lambda: rec.global_diff_update_compact(e, t, r, c, v, cap),
            rec.diff_compact, 2)
        plain = rec.global_diff_update_compact(e.cpu(), t.cpu(), r, c, v,
                                               cap)
        for g, w in zip(got, plain):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("S,N,p", [(1, 1, 1.0), (3, 5, 0.0), (7, 1000, 0.01),
                                   (BENCH[0], BENCH[1], 0.04)])
def test_diff_compact_kernel_matches_plain(cuda, S, N, p):
    mask = torch.from_numpy(np.random.default_rng(N).random((S, N)) < p) \
        .to(cuda)
    total = int(mask.sum())
    for cap in sorted({0, 1, max(total - 1, 0), total, total + 5}):
        got = _launched(lambda: rec.diff_compact(mask, cap), rec.diff_compact)
        want = rec.diff_compact_plain(mask, cap)
        assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
        assert int(got[1]) == total


@pytest.mark.parametrize("S,N,T", [(1, 1, 1), (10, 40, 17), BENCH])
def test_task_count_flat_kernel_matches_plain(cuda, S, N, T):
    _, _, tn = _problem(S, N, T, 3, hi=N + 3)
    (t,) = _dev(cuda, tn)
    got = _launched(lambda: rec.task_count_flat(t, N), rec.task_count_flat)
    assert got.dtype == torch.int32
    assert torch.equal(got, rec.task_count_flat_plain(t, N))


@pytest.mark.parametrize("S,N,T,U,B", [(2, 4, 3, 1, 1), (8, 200, 16, 20, 6),
                                       (12, 300, 20, 30, 10),
                                       (BENCH[0], BENCH[1], BENCH[2], 4_000,
                                        16)])
def test_churn_burst_kernel_matches_plain(cuda, S, N, T, U, B):
    bench = S * N >= 10_000_000
    if bench:
        rng, eligible, tn = _converged(S, N, T)
    else:
        rng, eligible, tn = _problem(S, N, T, U + B)
    e, t = _dev(cuda, eligible, tn)
    cnt = rec.task_count_flat(t, N)
    r, c, v = _burst(rng, S, T, U, B, N)
    if not bench:
        v[:, :1] = N                          # value N: the next row's count
    keep = (t.clone(), cnt.clone())
    got = _launched(
        lambda: rec.global_diff_churn_burst(e, t, cnt, r, c, v),
        rec.global_diff_churn_burst)
    assert torch.equal(t, keep[0]) and torch.equal(cnt, keep[1])
    want = rec.global_diff_churn_burst_plain(e, t, cnt, *_dev(cuda, r, c, v))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if bench:                                 # the carry is the recount
        assert torch.equal(got[1], rec.task_count_flat(got[0], N))
    one = _launched(lambda: rec.global_diff_churn(e, t, cnt, r[0], c[0],
                                                  v[0]),
                    rec.global_diff_churn_burst)
    want = rec.global_diff_churn_plain(e, t, cnt, *_dev(cuda, r[0], c[0],
                                                        v[0]))
    for g, w in zip(one, want):
        assert torch.equal(g, w)


def test_update_triples_on_the_card(cuda):
    """Triples already on the card are checked there and used as they are:
    the same results as host triples, and the same refusals."""
    S, N, T, U, B = 8, 200, 16, 20, 6
    rng, eligible, tn = _problem(S, N, T, 7)
    e, t = _dev(cuda, eligible, tn)
    cnt = rec.task_count_flat(t, N)
    r, c, v = _burst(rng, S, T, U, B, N)
    for host, card in (
            (lambda: rec.global_diff_churn_burst(e, t, cnt, r, c, v),
             lambda: rec.global_diff_churn_burst(e, t, cnt,
                                                 *_dev(cuda, r, c, v))),
            (lambda: rec.global_diff_churn(e, t, cnt, r[0], c[0], v[0]),
             lambda: rec.global_diff_churn(e, t, cnt,
                                           *_dev(cuda, r[0], c[0], v[0]))),
            (lambda: rec.global_diff_update(e, t, r[0], c[0], v[0]),
             lambda: rec.global_diff_update(e, t,
                                            *_dev(cuda, r[0], c[0], v[0])))):
        for g, w in zip(card(), host()):
            assert torch.equal(g, w)
    one = torch.zeros(1, dtype=torch.int32, device=cuda)
    for bad_r, bad_c in ((S, 0), (-1, 0), (0, T), (0, -1)):
        rr, cc = _dev(cuda, np.array([bad_r], np.int32),
                      np.array([bad_c], np.int32))
        with pytest.raises(ValueError, match="outside"):
            rec.global_diff_update(e, t, rr, cc, one)
        with pytest.raises(ValueError, match="outside"):
            rec.global_diff_churn(e, t, cnt, rr, cc, one)
    rr, vv = _dev(cuda, np.array([1], np.int32),
                  np.array([(1 << 31) - N // 2], np.int32))
    with pytest.raises(ValueError, match="2\\^31"):
        rec.global_diff_churn(e, t, cnt, rr, one, vv)


def test_empty_rounds_launch_nothing(cuda):
    _, eligible, tn = _problem(3, 8, 2, 1)
    e, t = _dev(cuda, eligible, tn)
    cnt = rec.task_count_flat(t, 8)
    z = np.zeros((2, 0), np.int32)
    got = _launched(lambda: rec.global_diff_churn_burst(e, t, cnt, z, z, z),
                    rec.global_diff_churn_burst, 0)
    assert tuple(got[2].shape) == (2, 0) and torch.equal(got[1], cnt)
