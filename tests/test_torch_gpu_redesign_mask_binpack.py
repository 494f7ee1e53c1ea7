"""The redesigned K21 (sharded binpack fill: binpack_select.cuh's
cap-weighted radix select over k node shards, one thread block cluster) and
K1 (static mask: one body behind the one-device entry and the sharded one,
every shard in one launch) against their plain PyTorch versions on the
card. Every test here is marked `gpu` and skips without a CUDA device; the
file imports neither JAX nor the JAX package, so on a machine without JAX
it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_redesign_mask_binpack.py

`mask_case` and `split_mask` are the edge-case generator that
tests/test_torch_redesign_mask_binpack_host.py also holds the plain
versions to the JAX reference with. Outputs are integer or bool: the
tolerance is exact equality of the counts, the flags, every folded state
field and every mask.
"""
import numpy as np
import pytest
import torch

from swarmkit_tpu_torch.ops import _kernels
from swarmkit_tpu_torch.ops import placement as torch_placement
from swarmkit_tpu_torch.parallel import fill as torch_fill
from tests.test_torch_gpu_redesign_fill import (
    FillState,
    assert_same,
    run_sharded,
    shard_case,
)
from tests.test_torch_gpu_redesign_flat_binpack import (
    flat_binpack_case,
    key_bits,
)

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu

VOL_TOPO_MOUNTS = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# ------------------------------------------------------ K1 generator
MASK_FIELDS = ("ready", "node_val", "node_plat", "node_plugins",
               "constraints", "plat_req", "req_plugins", "extra_mask",
               "vol_topo")
NODE_FIELDS = ("ready", "node_val", "node_plat", "node_plugins",
               "extra_mask")


def mask_case(seed, N, G=4, K=5, C=3, P=2, PL=3, VA=0, W=5):
    """K1's inputs as numpy arrays (a dict keyed by MASK_FIELDS, in
    `static_mask`'s argument order): key columns drawn from [-1, K + 1]
    (padding, and columns the gathers clamp), == and != constraints,
    platform rows with pad rows (<= -2) and wildcards (0), required
    plugins, a host-side extra mask, and VA volume-topology rows of
    (W - 1) / 2 segments whose mounts are drawn from [-1, 5] (mounts
    outside [0, 4) are no leg) and whose keys from [-1, K + 1]. Values
    are small, so every leg both passes and fails somewhere."""
    rng = np.random.RandomState(seed)
    cols = rng.randint(-1, K + 2, (G, C))
    cons = np.stack([cols, rng.randint(0, 2, (G, C)),
                     rng.randint(0, 3, (G, C))], -1)
    plat = np.stack([rng.choice([-3, -2, 0, 1, 2], (G, P)),
                     rng.choice([0, 1, 2], (G, P))], -1)
    vol = rng.randint(-1, K + 2, (G, VA, W))
    vol[:, :, 2::2] = rng.randint(0, 3, vol[:, :, 2::2].shape)
    if W:
        vol[:, :, 0] = rng.randint(-1, 6, (G, VA))
    return dict(
        ready=rng.rand(N) < 0.9,
        node_val=rng.randint(0, 3, (N, K)).astype(np.int32),
        node_plat=rng.randint(0, 3, (N, 2)).astype(np.int32),
        node_plugins=rng.rand(N, PL) < 0.8,
        constraints=cons.astype(np.int32),
        plat_req=plat.astype(np.int32),
        req_plugins=rng.rand(G, PL) < 0.15,
        extra_mask=rng.rand(G, N) < 0.9,
        vol_topo=vol.astype(np.int32))


def mask_args(case, device):
    """`static_mask`'s arguments of a `mask_case` on `device` (copies)."""
    return [torch.tensor(np.ascontiguousarray(case[f]), device=device)
            for f in MASK_FIELDS]


def split_mask(case, k, device, same_extra=False):
    """`sharded_static_mask`'s arguments of a `mask_case` over k shards of
    n = N / k nodes: the node-axis fields lists of k shard tensors, the
    group-side ones one tensor each. same_extra: one extra-mask tensor (the
    first shard's) stands for every shard, as the mesh tick passes its
    all-true table."""
    N = case["ready"].shape[0]
    assert N % k == 0
    n = N // k
    out = []
    for f in MASK_FIELDS:
        a = case[f]
        if f not in NODE_FIELDS:
            out.append(torch.tensor(np.ascontiguousarray(a), device=device))
            continue
        ax = 1 if f == "extra_mask" else 0
        parts = [torch.tensor(np.ascontiguousarray(
            np.take(a, range(b * n, (b + 1) * n), axis=ax)), device=device)
            for b in range(k)]
        if f == "extra_mask" and same_extra:
            parts = [parts[0]] * k
        out.append(parts)
    return out


def shard_args(args, b):
    """Shard b's `static_mask` arguments of `split_mask`'s lists."""
    return [a[b] if isinstance(a, list) else a for a in args]


MASK_CASES = [
    # (seed, k, n, options)
    (1, 1, 37, {}),
    (2, 2, 33, {"VA": 3}),
    (3, 3, 100, {"VA": 2, "W": 7, "PL": 0}),
    (4, 8, 250, {"G": 20, "C": 4, "P": 3}),
    (5, 8, 2_048, {"G": 20}),                    # the mesh tick's grid
    (6, 8, 16_384, {"G": 16, "VA": 1}),          # [mesh]'s scale-out
    (7, 5, 61, {"PL": 70}),                      # plugins past 64: a loop
    (8, 2, 50, {"G": 3, "C": 700}),              # rows read in place
    (9, 16, 129, {"G": 9, "VA": 4, "K": 1}),
    (10, 4, 1, {"G": 17}),
]
MASK_IDS = [f"s{c[0]}-k{c[1]}-n{c[2]}" + "".join(
    f"-{a}{v}" for a, v in c[3].items()) for c in MASK_CASES]


def _plain_masks(args, k):
    return [torch_placement.static_mask_plain(*shard_args(args, b))
            for b in range(k)]


@pytest.mark.parametrize("seed,k,n,opts", MASK_CASES, ids=MASK_IDS)
def test_sharded_static_mask_matches_plain(cuda, seed, k, n, opts):
    case = mask_case(seed, k * n, **opts)
    args = split_mask(case, k, cuda)
    before = torch_placement.sharded_static_mask.launches
    got = torch_placement.sharded_static_mask(*args)
    torch.cuda.synchronize()
    assert torch_placement.sharded_static_mask.launches == before + 1
    want = _plain_masks(args, k)
    assert len(got) == k
    for g, w in zip(got, want):
        assert g.dtype == torch.bool and g.is_contiguous()
        assert torch.equal(g, w)
    # the joined masks are the one-device mask of the joined arrays
    joined = torch_placement.static_mask_plain(*mask_args(case, cuda))
    assert torch.equal(torch.cat(got, 1), joined)


@pytest.mark.parametrize("seed,k,n,opts", MASK_CASES, ids=MASK_IDS)
def test_static_mask_matches_plain(cuda, seed, k, n, opts):
    case = mask_case(seed, k * n, **opts)
    args = mask_args(case, cuda)
    before = torch_placement.static_mask.launches
    got = torch_placement.static_mask(*args)
    torch.cuda.synchronize()
    assert torch_placement.static_mask.launches == before + 1
    assert torch.equal(got, torch_placement.static_mask_plain(*args))


@pytest.mark.parametrize("k", [1, 2, 8])
def test_sharded_static_mask_same_extra_everywhere(cuda, k):
    case = mask_case(21, k * 300, G=6, VA=2)
    args = split_mask(case, k, cuda, same_extra=True)
    assert all(e is args[7][0] for e in args[7])
    got = torch_placement.sharded_static_mask(*args)
    for g, w in zip(got, _plain_masks(args, k)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("G,n", [(0, 40), (5, 0), (0, 0)])
def test_empty_masks_launch_nothing(cuda, G, n):
    k = 3
    case = mask_case(22, k * n, G=G, VA=1)
    args = split_mask(case, k, cuda)
    s0 = torch_placement.sharded_static_mask.launches
    got = torch_placement.sharded_static_mask(*args)
    assert torch_placement.sharded_static_mask.launches == s0
    assert [tuple(m.shape) for m in got] == [(G, n)] * k
    one = mask_args(case, cuda)
    o0 = torch_placement.static_mask.launches
    assert tuple(torch_placement.static_mask(*one).shape) == (G, k * n)
    assert torch_placement.static_mask.launches == o0


def test_sharded_static_mask_refuses_as_the_shard_loop(cuda):
    """A faulty shard raises the error a loop of `static_mask` calls
    raises; so does a node table without key columns."""
    case = mask_case(23, 3 * 40)
    args = split_mask(case, 3, cuda)
    bad = [list(a) if isinstance(a, list) else a for a in args]
    bad[2][1] = bad[2][1].to(torch.int64)                 # node_plat
    with pytest.raises(TypeError, match="node_plat: dtype"):
        torch_placement.sharded_static_mask(*bad)
    bad = [list(a) if isinstance(a, list) else a for a in args]
    bad[1] = [v[:, :0].contiguous() for v in bad[1]]      # K = 0
    with pytest.raises(ValueError, match="at least one key column"):
        torch_placement.sharded_static_mask(*bad)
    bad = [list(a) if isinstance(a, list) else a for a in args]
    for i in (0, 1, 2, 3, 7):                  # shard 2 one node narrower
        bad[i][2] = bad[i][2][..., :-1].contiguous() if i in (0, 7) \
            else bad[i][2][:-1].contiguous()
    with pytest.raises(ValueError, match="widths"):
        torch_placement.sharded_static_mask(*bad)


# ------------------------------------------------------------ K21
SHARD_CASES = [
    # (seed, k, n, G, options); n is not a multiple of 32
    (1, 1, 37, 3, {}),
    (2, 2, 33, 4, {"phantoms": 5}),
    (3, 3, 101, 4, {"wide": True}),              # keys past 63 bits
    (4, 8, 250, 4, {"exact_quota": True, "phantoms": 11}),
    (5, 8, 1_001, 3, {"zero_cap": True, "over_quota": True}),
    (6, 16, 77, 3, {"overflow": True}),
    (7, 16, 1_250, 3, {"one_chunk": True}),
    (8, 8, 2_001, 3, {"wide": True, "phantoms": 3}),
    (9, 3, 5_003, 3, {"ties": False, "over_quota": True}),
    (10, 8, 16_384, 2, {}),                      # [mesh]'s scale-out
    (11, 16, 20_001, 2, {}),                     # nodes in device scratch
    (12, 16, 20_003, 2, {"wide": True, "overflow": True}),
]
SHARD_IDS = [f"s{c[0]}-k{c[1]}-n{c[2]}" + "".join(f"-{o}" for o in c[4])
             for c in SHARD_CASES]


def _binpack_case(seed, k, n, G, opts):
    return flat_binpack_case(seed, k * n, G, **opts)


@pytest.mark.parametrize("seed,k,n,G,opts", SHARD_CASES, ids=SHARD_IDS)
def test_sharded_binpack_fill_matches_plain(cuda, seed, k, n, G, opts):
    case = _binpack_case(seed, k, n, G, opts)
    step = torch_fill.sharded_binpack_fill_step
    before = step.launches
    got = run_sharded(step, case, k, cuda)
    torch.cuda.synchronize()
    assert step.launches == before + G                # one launch a group
    assert_same(got, run_sharded(torch_fill.sharded_binpack_fill_step_plain,
                                 case, k, cuda))
    if opts.get("overflow"):
        assert int(got[1][G - 1]) == 1
        assert not got[0][G - 1].any()
    # the node route the plan takes: shared memory up to ~280k nodes
    C, smem, on_chip = torch_fill.binpack_plan(k, n)
    assert C in (1, 2, 4, 8, 16)
    assert on_chip == (k * n < 250_000)


@pytest.mark.parametrize("i", [1, 5, 9, 11])
def test_sharded_fill_binpack_loop_matches_plain(cuda, i):
    """The launch loop's K21 steps (one check, one pointer table, a launch
    a group) against the plain steps."""
    seed, k, n, G, opts = SHARD_CASES[i]
    case = _binpack_case(seed, k, n, G, opts)
    tables, states = shard_case(case, k, cuda)
    step = torch_fill.sharded_binpack_fill_step
    before = step.launches
    counts, flags = torch_fill.sharded_fill(tables, states, 1)
    torch.cuda.synchronize()
    assert step.launches == before + G
    joined = FillState(*(torch.cat([getattr(s, f).cpu() for s in states],
                                   dim=1 if f == "svc_counts" else 0)
                         for f in FillState._fields))
    got = torch.cat([c.cpu() for c in counts], 1), flags.cpu(), joined
    assert_same(got, run_sharded(torch_fill.sharded_binpack_fill_step_plain,
                                 case, k, cuda))


def test_the_cases_cover_both_key_routes():
    packed = wide = 0
    for seed, k, n, G, opts in SHARD_CASES:
        if k * n > 20_000:
            continue
        bits = [b for b in key_bits(_binpack_case(seed, k, n, G, opts))
                if b is not None]
        packed += sum(b <= 63 for b in bits)
        wide += sum(b > 63 for b in bits)
    assert packed and wide


def test_shard_limit(cuda):
    """K21's limit is a fixed 1,024 shards, no longer co-residency: it
    launches there and one more raises at the launch."""
    most = torch_fill.max_shards(1)
    assert most == 1024 == torch_fill.max_shards(0)
    case = flat_binpack_case(31, most, 1)
    got = run_sharded(torch_fill.sharded_binpack_fill_step, case, most,
                      cuda)
    assert_same(got, run_sharded(torch_fill.sharded_binpack_fill_step_plain,
                                 case, most, cuda))
    case = flat_binpack_case(32, most + 1, 1)
    tables, states = shard_case(case, most + 1, cuda)
    outs = [torch.zeros((1, 1), dtype=torch.int32, device=cuda)
            for _ in tables]
    flags = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(_kernels.KernelLaunchError):
        torch_fill.sharded_binpack_fill_step(tables, states, 0, outs, flags)


# ------------------------------------------------------------ graphs
def test_graph_replay_equals_eager(cuda):
    """A K21 step, a one-device K1 call and a sharded K1 call captured in
    one CUDA graph: the replay on the same inputs gives the eager calls'
    counts, flags, state and masks."""
    k, n, G = 8, 2_001, 2
    case = flat_binpack_case(61, k * n, G)
    tables, s0 = shard_case(case, k, cuda)
    mcase = mask_case(62, k * 300, G=5, VA=2)
    sharded, one = split_mask(mcase, k, cuda), mask_args(mcase, cuda)

    def fresh():
        return ([FillState(*(x.clone() for x in st)) for st in s0],
                [torch.zeros((G, n), dtype=torch.int32, device=cuda)
                 for _ in range(k)],
                torch.zeros(G, dtype=torch.int32, device=cuda))

    def step(states, outs, flags):
        torch_fill.sharded_binpack_fill_step(tables, states, 0, outs, flags)
        return (torch_placement.static_mask(*one),
                torch_placement.sharded_static_mask(*sharded))

    eager = fresh()
    eager_masks = step(*eager)
    cap = fresh()
    snapshot = [x.clone() for st in cap[0] for x in st]
    step(*cap)                           # warm: builds, fills the caches
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        masks = step(*cap)
    for dst, src in zip([x for st in cap[0] for x in st], snapshot):
        dst.copy_(src)
    for x in (*cap[1], cap[2], masks[0], *masks[1]):
        x.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip((*cap[1], cap[2], *[x for st in cap[0] for x in st]),
                    (*eager[1], eager[2],
                     *[x for st in eager[0] for x in st])):
        assert torch.equal(a, b)
    assert torch.equal(masks[0], eager_masks[0])
    for a, b in zip(masks[1], eager_masks[1]):
        assert torch.equal(a, b)
