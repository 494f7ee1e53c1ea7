"""The redesigned K3 (tree fill) and K20 (sharded water fill), one device
body (csrc/water_fill.cuh: several bits of each water level and remainder
key a pass, one thread block cluster, the per-step state on chip), against
their plain PyTorch versions on the card. Every test here is marked `gpu`
and skips without a CUDA device; the file imports neither JAX nor the JAX
package, so on a machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_redesign_fill.py

`fill_case` and `shard_case` are the edge-case generator that
tests/test_torch_redesign_fill_host.py also holds the plain versions to
the JAX reference with. Outputs are integer: the tolerance is exact
equality of the counts, the flags and every folded state field.
"""
import numpy as np
import pytest
import torch

from swarmkit_tpu_torch.ops import _kernels
from swarmkit_tpu_torch.ops import placement as torch_placement
from swarmkit_tpu_torch.parallel import fill as torch_fill

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu

FillTables = torch_placement.FillTables
FillState = torch_placement.FillState


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# ------------------------------------------------------------ generator
def _prefix_ranks(rng, N, L, arity, nb, leaf_unique):
    """int32[L, N] nested branch ids: level li's id is a rank of the node's
    label prefix; the ids of a level are spread over [0, nb) (gaps, any
    order; at most N). leaf_unique: every node its own last-level
    branch."""
    ranks = np.zeros((L, N), np.int32)
    nb = min(nb, N)                       # ids stay below N, as encoded
    labels = rng.randint(0, max(arity, 1), size=(L, N))
    if leaf_unique and L:
        labels[L - 1] = np.arange(N)
    for li in range(L):
        _, inv = np.unique(labels[:li + 1].T, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        n_br = int(inv.max()) + 1
        ids = rng.choice(max(nb, n_br), n_br, replace=False) \
            if nb > n_br else rng.permutation(n_br)
        ranks[li] = ids[inv]
    return ranks


def fill_case(seed, N, G=3, L=2, arity=3, nb=0, leaf_unique=False,
              ties=True, R=2, PV=3, S=3, zero_cap=False, over_quota=False,
              overflow=False, phantoms=0):
    """One-device fill inputs as numpy arrays: a dict of the FillTables and
    FillState fields (int32 / bool). nb: the ids of each level drawn from
    [0, nb) (0: dense); ties: totals from {0, 1, 2} so (totals + c) ties
    and the node index decides; zero_cap: group 0 eligible nowhere;
    over_quota: group 1 asks for more than the nodes hold; overflow: group
    G - 1's capacity sum reaches 2^31; phantoms: the last nodes padded as
    the mesh pads them (ineligible, branch 0, empty state)."""
    rng = np.random.RandomState(seed)
    mask = rng.rand(G, N) < 0.85
    need = rng.choice([0, 1, 2, 5], size=(G, R)).astype(np.int32)
    n_tasks = rng.choice([0, 1, 7, 40, 300], size=G).astype(np.int32)
    svc_idx = rng.randint(0, S, G).astype(np.int32)
    max_rep = rng.choice([0, 0, 2, 5], size=G).astype(np.int32)
    penalty = rng.rand(G, N) < 0.2
    has_ports = rng.rand(G) < 0.3
    group_ports = rng.rand(G, PV) < 0.3
    ranks = np.stack([_prefix_ranks(rng, N, L, arity, nb, leaf_unique)
                      for _ in range(G)]) if L else \
        np.zeros((G, 0, N), np.int32)
    totals = rng.randint(0, 3 if ties else 40, N).astype(np.int32)
    svc_counts = rng.randint(0, 4, (S, N)).astype(np.int32)
    avail = rng.randint(0, 40, (N, R)).astype(np.int32)
    port_used = rng.rand(N, PV) < 0.2
    if zero_cap:
        mask[0] = False
    if over_quota and G > 1:
        n_tasks[1] = 100_000
    if overflow:
        g = G - 1
        mask[g], need[g], max_rep[g], has_ports[g] = True, 0, 0, False
        n_tasks[g] = 1 << 30
    if phantoms:
        sl = slice(N - phantoms, N)
        mask[:, sl], penalty[:, sl], ranks[:, :, sl] = False, False, 0
        totals[sl], svc_counts[:, sl], avail[sl], port_used[sl] = \
            0, 0, 0, False
    return dict(mask=mask, need_res=need, n_tasks=n_tasks, svc_idx=svc_idx,
                max_replicas=max_rep, penalty=penalty, has_ports=has_ports,
                group_ports=group_ports, spread_rank=ranks, totals=totals,
                svc_counts=svc_counts, avail=avail, port_used=port_used)


def _tensor(a, device):
    """A copy of a numpy array on `device` (never sharing the case's
    memory: the steps fold the state in place)."""
    return torch.tensor(np.ascontiguousarray(a), device=device)


def to_fill(case, device):
    """(FillTables, FillState) tensors of a `fill_case` on `device`."""
    t = FillTables(*(_tensor(case[f], device) for f in FillTables._fields))
    s = FillState(*(_tensor(case[f], device) for f in FillState._fields))
    return t, s


def shard_case(case, k, device):
    """The `fill_case` split over k shards of n = N / k nodes (the sharded
    steps' per-shard tables and states; the group-side tables one shared
    copy)."""
    N = case["mask"].shape[1]
    assert N % k == 0
    n = N // k
    group = {f: _tensor(case[f], device) for f in
             ("need_res", "n_tasks", "svc_idx", "max_replicas", "has_ports",
              "group_ports")}
    tables, states = [], []
    for b in range(k):
        sl = slice(b * n, (b + 1) * n)
        col = {"mask": case["mask"][:, sl], "penalty": case["penalty"][:, sl],
               "spread_rank": case["spread_rank"][:, :, sl]}
        tables.append(FillTables(*(
            group[f] if f in group else
            _tensor(col[f], device) for f in FillTables._fields)))
        st = {"totals": case["totals"][sl],
              "svc_counts": case["svc_counts"][:, sl],
              "avail": case["avail"][sl], "port_used": case["port_used"][sl]}
        states.append(FillState(*(_tensor(st[f], device)
                                  for f in FillState._fields)))
    return tables, states


def n_branches(case):
    r = case["spread_rank"]
    return int(r.max()) + 1 if r.size else 1


def run_tree(step, case, device):
    """Every group's K3 step (or its plain version) in order: (counts,
    flags, folded state) on the host."""
    t, s = to_fill(case, device)
    G, N = case["mask"].shape
    out = torch.full((G, N), -7, dtype=torch.int32, device=device)
    flags = torch.full((G,), -7, dtype=torch.int32, device=device)
    for g in range(G):
        step(t, s, g, out, flags)
    return out.cpu(), flags.cpu(), FillState(*(x.cpu() for x in s))


def run_sharded(step, case, k, device, nb=None):
    """Every group's K20 step (or its plain version) over k shards:
    (joined counts, flags, joined state) on the host."""
    tables, states = shard_case(case, k, device)
    G, N = case["mask"].shape
    n = N // k
    outs = [torch.full((G, n), -7, dtype=torch.int32, device=device)
            for _ in range(k)]
    flags = torch.full((G,), -7, dtype=torch.int32, device=device)
    for g in range(G):
        step(tables, states, g, outs, flags, *(() if nb is None else (nb,)))
    joined = FillState(*(torch.cat([getattr(s, f).cpu() for s in states],
                                   dim=0 if f in ("totals", "avail",
                                                  "port_used") else 1)
                         for f in FillState._fields))
    return torch.cat([o.cpu() for o in outs], 1), flags.cpu(), joined


def assert_same(got, want):
    (c1, f1, s1), (c2, f2, s2) = got, want
    assert torch.equal(f1, f2), (f1, f2)
    assert torch.equal(c1, c2), int((c1 - c2).abs().max())
    for f in FillState._fields:
        assert torch.equal(getattr(s1, f), getattr(s2, f)), f


# --------------------------------------------------------------- K3
TREE_CASES = [
    # (seed, N, G, L, arity, nb, leaf_unique, options)
    (1, 64, 3, 1, 1, 0, False, {}),              # NB = 1
    (2, 64, 3, 1, 4, 0, True, {}),               # NB = N, one level
    (3, 300, 4, 2, 3, 0, True, {}),              # NB = N, two levels
    (4, 500, 4, 1, 5, 0, False, {}),
    (5, 700, 4, 2, 3, 40, False, {}),
    (6, 1000, 4, 3, 3, 0, False, {}),
    (7, 1500, 3, 4, 2, 200, False, {}),
    (8, 2048, 3, 4, 3, 0, False, {"ties": False}),
    (9, 3000, 4, 2, 6, 0, False, {"zero_cap": True, "over_quota": True}),
    (10, 700, 4, 3, 3, 0, False, {"overflow": True}),
    (11, 5000, 3, 3, 4, 0, False, {"phantoms": 37}),
    (12, 9000, 3, 2, 8, 300, False, {}),          # global route (NB > 256)
    (13, 600, 3, 2, 3, 0, True, {"over_quota": True}),
    (14, 20_000, 2, 2, 5, 0, False, {}),          # nodes past one block's
]


@pytest.mark.parametrize("seed,N,G,L,arity,nb,leaf_unique,opts", TREE_CASES)
def test_tree_fill_matches_plain(cuda, seed, N, G, L, arity, nb,
                                 leaf_unique, opts):
    case = fill_case(seed, N, G, L, arity, nb, leaf_unique, **opts)
    before = torch_placement.tree_fill_step.launches
    got = run_tree(torch_placement.tree_fill_step, case, cuda)
    torch.cuda.synchronize()
    assert torch_placement.tree_fill_step.launches == before + G
    assert_same(got, run_tree(torch_placement.tree_fill_step_plain, case,
                              cuda))
    if opts.get("overflow"):
        assert int(got[1][G - 1]) == 1
        assert not got[0][G - 1].any()


def test_tree_fill_mesh_one_device_shape(cuda):
    # the largest K3 shape a path launches: [mesh]'s one-device comparison
    # (131,072 nodes, LMAX 2, 128 branches)
    case = fill_case(21, 131_072, 2, 2, 8, 128, False)
    assert_same(run_tree(torch_placement.tree_fill_step, case, cuda),
                run_tree(torch_placement.tree_fill_step_plain, case, cuda))


# --------------------------------------------------------------- K20
SHARD_CASES = [
    # (seed, k, n, G, L, arity, nb, leaf_unique, options)
    (31, 1, 64, 3, 0, 1, 0, False, {}),
    (32, 2, 50, 3, 0, 1, 0, False, {"phantoms": 7}),
    (33, 3, 41, 3, 1, 3, 0, False, {}),
    (34, 8, 9, 3, 2, 3, 0, True, {}),             # NB = N, N < 16 blocks
    (35, 8, 128, 4, 2, 4, 0, False, {"phantoms": 13}),
    (36, 16, 100, 3, 3, 3, 0, False, {"over_quota": True}),
    (37, 32, 33, 3, 4, 2, 90, False, {"zero_cap": True}),
    (38, 132, 5, 3, 1, 1, 0, False, {}),          # NB = 1, k = 132
    (39, 132, 31, 3, 2, 3, 0, False, {"ties": False}),
    (40, 8, 2048, 4, 0, 1, 0, False, {}),         # the mesh tick's shape
    (41, 8, 1100, 3, 2, 6, 400, False, {}),       # global route
    (42, 4, 300, 4, 2, 3, 0, False, {"overflow": True}),
    (43, 2, 3000, 3, 1, 5, 0, True, {}),          # NB = N, global route
    (44, 16, 1500, 2, 0, 1, 0, False, {"over_quota": True}),
]


@pytest.mark.parametrize("seed,k,n,G,L,arity,nb,leaf_unique,opts",
                         SHARD_CASES)
def test_sharded_water_fill_matches_plain(cuda, seed, k, n, G, L, arity, nb,
                                          leaf_unique, opts):
    case = fill_case(seed, k * n, G, L, arity, nb, leaf_unique, **opts)
    nbr = n_branches(case)
    before = torch_fill.sharded_water_fill_step.launches
    got = run_sharded(torch_fill.sharded_water_fill_step, case, k, cuda, nbr)
    torch.cuda.synchronize()
    assert torch_fill.sharded_water_fill_step.launches == before + G
    assert_same(got, run_sharded(torch_fill.sharded_water_fill_step_plain,
                                 case, k, cuda))


@pytest.mark.parametrize("k", [1, 8])
def test_sharded_water_fill_default_branch_bound(cuda, k):
    # without n_branches every id below the padded count is a slot
    case = fill_case(51, k * 96, 3, 2, 3)
    assert_same(run_sharded(torch_fill.sharded_water_fill_step, case, k,
                            cuda),
                run_sharded(torch_fill.sharded_water_fill_step_plain, case,
                            k, cuda))


def test_sharded_water_fill_scale_out_shape(cuda):
    # [mesh]'s scale-out spread shape: 8 x 16,384 nodes, LMAX 2, 128 slots
    case = fill_case(52, 8 * 16_384, 2, 2, 8, 128, False)
    assert_same(run_sharded(torch_fill.sharded_water_fill_step, case, 8,
                            cuda, n_branches(case)),
                run_sharded(torch_fill.sharded_water_fill_step_plain, case,
                            8, cuda))


def test_shard_limit_unchanged(cuda):
    # every shard count the cooperative K20 took (one block an SM) still
    # launches; one past the limit raises at the launch
    most = torch_fill.max_shards(0)
    assert most >= torch.cuda.get_device_properties(0).multi_processor_count
    case = fill_case(53, most + 1, 1, 0)
    tables, states = shard_case(case, most + 1, cuda)
    outs = [torch.zeros((1, 1), dtype=torch.int32, device=cuda)
            for _ in tables]
    flags = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(_kernels.KernelLaunchError):
        torch_fill.sharded_water_fill_step(tables, states, 0, outs, flags, 1)


# ------------------------------------------------------------ graphs
def test_graph_replay_equals_eager(cuda):
    """One K3 and one K20 step captured in a CUDA graph: the replay on the
    same inputs gives the eager call's counts, flags and state."""
    case = fill_case(61, 8 * 512, 2, 2, 4)
    t, s0 = to_fill(case, cuda)
    G, N = case["mask"].shape
    tables, states0 = shard_case(case, 8, cuda)
    nbr = n_branches(case)

    def fresh():
        st = FillState(*(x.clone() for x in s0))
        sts = [FillState(*(x.clone() for x in s)) for s in states0]
        return (st, torch.zeros((G, N), dtype=torch.int32, device=cuda),
                sts, [torch.zeros((G, N // 8), dtype=torch.int32,
                                  device=cuda) for _ in range(8)],
                torch.zeros(G, dtype=torch.int32, device=cuda),
                torch.zeros(G, dtype=torch.int32, device=cuda))

    def step(st, out, sts, outs, f3, f20):
        torch_placement.tree_fill_step(t, st, 0, out, f3)
        torch_fill.sharded_water_fill_step(tables, sts, 0, outs, f20, nbr)

    eager = fresh()
    step(*eager)
    cap = fresh()
    snapshot = [x.clone() for x in (*cap[0], *[y for s in cap[2] for y in s])]
    step(*cap)                           # warm: builds, fills the caches
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step(*cap)
    for dst, src in zip((*cap[0], *[y for s in cap[2] for y in s]),
                        snapshot):
        dst.copy_(src)
    for x in (cap[1], *cap[3], cap[4], cap[5]):
        x.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(cap[1], eager[1]) and torch.equal(cap[4], eager[4])
    assert torch.equal(cap[5], eager[5])
    for a, b in zip(cap[3], eager[3]):
        assert torch.equal(a, b)
    for a, b in zip((*cap[0], *[y for s in cap[2] for y in s]),
                    (*eager[0], *[y for s in eager[2] for y in s])):
        assert torch.equal(a, b)
