"""The redesigned K2 (flat fill: water_fill.cuh's L = 0 path over one
shard, one branch slot) and K9 (binpack fill: binpack_select.cuh, a
cap-weighted radix select over one thread block cluster) against their
plain PyTorch versions on the card. Every test here is marked `gpu` and
skips without a CUDA device; the file imports neither JAX nor the JAX
package, so on a machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_redesign_flat_binpack.py

`flat_binpack_case` is the edge-case generator that
tests/test_torch_redesign_binpack_host.py also holds the plain versions to
the JAX reference with. Outputs are integer: the tolerance is exact
equality of the counts, the flags and every folded state field.
"""
import ctypes

import numpy as np
import pytest
import torch

from swarmkit_tpu_torch.ops import _kernels
from swarmkit_tpu_torch.ops import placement as torch_placement
from tests.test_torch_gpu_redesign_fill import (
    FillState,
    assert_same,
    fill_case,
    run_tree,
    to_fill,
)

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu

UNLIMITED = 1 << 30
CHUNK = 32            # the nodes a block is dealt at a time
WIDE = (1 << 30) - 1000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# ------------------------------------------------------------ generator
def np_caps(case, g):
    """Group g's capacity per node under the case's initial state, before
    eligibility and the n_tasks clip (the reference's step)."""
    need = case["need_res"][g]
    svc = case["svc_counts"][case["svc_idx"][g]]
    caps = np.where(need[None, :] > 0,
                    case["avail"] // np.maximum(need, 1)[None, :], UNLIMITED)
    mr = case["max_replicas"][g]
    cap_mr = np.where(mr > 0, mr - svc, UNLIMITED)
    conflict = (case["group_ports"][g][None, :] & case["port_used"]).any(1)
    cap_port = np.where(case["has_ports"][g], np.where(conflict, 0, 1),
                        UNLIMITED)
    return np.clip(np.minimum(np.minimum(caps.min(axis=1), cap_mr),
                              cap_port), 0, UNLIMITED).astype(np.int64)


def flat_binpack_case(seed, N, G=3, exact_quota=False, one_chunk=False,
                      wide=False, **opts):
    """One-device fill inputs with no spread levels (`fill_case` with L = 0
    and its options: ties, zero_cap, over_quota, overflow) and these:
    exact_quota: group 0 asks for exactly its capacity (q == capsum);
    one_chunk: every group eligible only on the second chunk of 32 nodes
    (the first when N <= 32), so one block of a cluster holds them all;
    wide: service and total counts spread over ~2^30 with no replica cap,
    so the binpack key's fields pass 63 bits (from N = 5 on)."""
    case = fill_case(seed, N, G, L=0, **opts)
    rng = np.random.RandomState(seed + 1000)
    if wide:
        case["max_replicas"][:] = 0
        case["svc_counts"] = np.where(
            rng.rand(*case["svc_counts"].shape) < 0.5,
            rng.randint(0, 4, case["svc_counts"].shape),
            WIDE - rng.randint(0, 4, case["svc_counts"].shape)
        ).astype(np.int32)
        case["totals"] = np.where(rng.rand(N) < 0.5, rng.randint(0, 3, N),
                                  WIDE - rng.randint(0, 3, N)
                                  ).astype(np.int32)
    if one_chunk:
        sl = slice(CHUNK, 2 * CHUNK) if N > CHUNK else slice(0, N)
        keep = np.zeros(N, bool)
        keep[sl] = True
        case["mask"] &= keep[None, :]
        case["mask"][:, sl] |= rng.rand(G, len(range(N)[sl])) < 0.5
    if exact_quota:
        case["need_res"][0] = np.maximum(case["need_res"][0], 1)
        cap = np.where(case["mask"][0], np_caps(case, 0), 0)
        case["n_tasks"][0] = int(cap.sum())
    return case


def key_bits(case, device=torch.device("cpu")):
    """Per group, the binpack key's width in bits (1 + bits(svc range) +
    bits(total range) + bits(N - 1), ranges over the nodes with capacity)
    under the state the group's step sees, or None where the step does no
    search (q == 0 or q >= capsum, or a refused group): the route K9 takes
    is the packed key up to 63 bits, the components above."""
    t, s = to_fill(case, device)
    G, N = case["mask"].shape
    out = torch.zeros((G, N), dtype=torch.int32, device=device)
    flags = torch.zeros(G, dtype=torch.int32, device=device)
    widths = []
    for g in range(G):
        cap, svc = torch_placement._node_caps_plain(t, s, g)
        capsum = int(cap.sum(dtype=torch.int64))
        q = min(int(t.n_tasks[g]), capsum)
        if capsum >= 1 << 31 or q <= 0 or q >= capsum:
            widths.append(None)
        else:
            has = cap > 0
            sv, tot = svc[has].long(), s.totals[has].long()
            widths.append(1 + int(sv.max() - sv.min()).bit_length()
                          + int(tot.max() - tot.min()).bit_length()
                          + (N - 1).bit_length())
        torch_placement.binpack_fill_step_plain(t, s, g, out, flags)
    return widths


CASES = [
    # (seed, N, G, options)
    (1, 1, 3, {}),
    (2, 31, 3, {}),
    (3, 33, 4, {}),
    (4, 33, 3, {"wide": True}),
    (5, 200, 4, {"exact_quota": True}),
    (6, 700, 4, {"zero_cap": True, "over_quota": True}),
    (7, 1000, 3, {"wide": True, "exact_quota": True}),
    (8, 2000, 4, {"one_chunk": True}),
    (9, 700, 3, {"overflow": True}),
    (10, 31, 3, {"one_chunk": True, "exact_quota": True}),
    (11, 10_000, 4, {}),
    (12, 10_000, 3, {"one_chunk": True, "exact_quota": True}),
    (13, 16_384, 3, {"ties": False}),
    (14, 16_384, 3, {"wide": True, "over_quota": True}),
    (15, 131_072, 2, {}),
    (16, 131_072, 2, {"overflow": True}),
]
CASE_IDS = [f"s{c[0]}-N{c[1]}" + "".join(f"-{k}" for k in c[3])
            for c in CASES]


def _check_step(cuda, name, seed, N, G, opts):
    case = flat_binpack_case(seed, N, G, **opts)
    step = getattr(torch_placement, f"{name}_fill_step")
    before = step.launches
    got = run_tree(step, case, cuda)
    torch.cuda.synchronize()
    assert step.launches == before + G
    assert_same(got, run_tree(getattr(torch_placement,
                                      f"{name}_fill_step_plain"), case, cuda))
    if opts.get("overflow"):
        assert int(got[1][G - 1]) == 1
        assert not got[0][G - 1].any()


@pytest.mark.parametrize("seed,N,G,opts", CASES, ids=CASE_IDS)
def test_flat_fill_matches_plain(cuda, seed, N, G, opts):
    _check_step(cuda, "flat", seed, N, G, opts)


@pytest.mark.parametrize("seed,N,G,opts", CASES, ids=CASE_IDS)
def test_binpack_fill_matches_plain(cuda, seed, N, G, opts):
    _check_step(cuda, "binpack", seed, N, G, opts)


# ------------------------------------------------------------ plans
def plan(name, N):
    """The C plan query of K2 (4 ints: cluster, dynamic shared memory,
    nodes in shared memory, shared route) or K9 (the first three)."""
    buf = (ctypes.c_int * 4)()
    rc = getattr(_kernels.lib(f"{name}_fill"), f"skt_{name}_fill_plan")(
        N, buf)
    assert rc == 0, rc
    return list(buf) if name == "flat" else list(buf)[:3]


@pytest.mark.parametrize("N", [1, 31, 33, 10_000, 16_384, 131_072])
def test_plans(cuda, N):
    flat, binpack = plan("flat", N), plan("binpack", N)
    for C in (flat[0], binpack[0]):
        assert C in (1, 2, 4, 8, 16)
        # about 1,024 nodes a block, up to the card's largest cluster
        assert C == 16 or C * 1024 >= N
        assert C == 1 or (C // 2) * 1024 < N
    assert flat[2] == 1 and flat[3] == 1       # nodes on chip, shared route
    assert binpack[2] == 1 and binpack[1] > 0  # nodes on chip
    if N == 131_072:
        assert flat[0] == 16 and binpack[0] == 16


# ------------------------------------------------------------ graphs
def test_graph_replay_equals_eager(cuda):
    """One K2 and one K9 step captured in a CUDA graph: the replay on the
    same inputs gives the eager calls' counts, flags and state."""
    case = flat_binpack_case(61, 16_384, 2)
    t, s0 = to_fill(case, cuda)
    G, N = case["mask"].shape

    def fresh():
        return ([FillState(*(x.clone() for x in s0)) for _ in range(2)],
                [torch.zeros((G, N), dtype=torch.int32, device=cuda)
                 for _ in range(2)],
                [torch.zeros(G, dtype=torch.int32, device=cuda)
                 for _ in range(2)])

    def step(states, outs, flags):
        torch_placement.flat_fill_step(t, states[0], 0, outs[0], flags[0])
        torch_placement.binpack_fill_step(t, states[1], 0, outs[1],
                                          flags[1])

    eager = fresh()
    step(*eager)
    cap = fresh()
    snapshot = [x.clone() for st in cap[0] for x in st]
    step(*cap)                           # warm: builds, fills the caches
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step(*cap)
    for dst, src in zip([x for st in cap[0] for x in st], snapshot):
        dst.copy_(src)
    for x in (*cap[1], *cap[2]):
        x.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip((*cap[1], *cap[2], *[x for st in cap[0] for x in st]),
                    (*eager[1], *eager[2],
                     *[x for st in eager[0] for x in st])):
        assert torch.equal(a, b)
