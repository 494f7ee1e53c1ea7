"""Binpack placement of the PyTorch port against the JAX reference.

The port's binpack step (`binpack_fill_step`, kernel K9 on the card, its
plain PyTorch version here) must equal the JAX `schedule_groups(...,
strategy=1)`, the heap oracle `spread.binpack_fill` and the closed form
`spread.binpack_reference` on every entry: the one-shot `schedule_groups`,
`schedule_groups_compact` (int16), `schedule_encoded`, `cluster_step` and
the resident tick. Slot orders must equal `binpack_slot_order`. Every
output is integer or bool, so the tolerance is exact equality. The kernel
itself is held against the plain version on the card
(tests/test_torch_gpu_binpack.py).
"""
import random

import numpy as np
import pytest
import torch

from swarmkit_tpu.models import cluster_step as jax_cluster_step
from swarmkit_tpu.ops import placement as jax_placement
from swarmkit_tpu.scheduler import batch as jax_batch
from swarmkit_tpu.scheduler import encode as jax_encode
from swarmkit_tpu.scheduler import spread as jax_spread
from swarmkit_tpu_torch import convert
from swarmkit_tpu_torch.models import cluster_step as torch_cluster_step
from swarmkit_tpu_torch.ops import placement as torch_placement
from swarmkit_tpu_torch.scheduler import batch as torch_batch
from swarmkit_tpu_torch.scheduler import spread as torch_spread
from test_torch_placement import (
    TORCH_API,
    _with_vol_topo,
    jax_problem,
    problem_fields,
    random_cluster,
)
from test_torch_resident import (
    NOW,
    SIDES,
    apply_tick,
    assert_fold,
    assert_states_equal,
    counters,
    make_info,
    make_waves,
    mutate,
    odd_group,
    plain_group,
    resident_of,
    service_group,
)

torch.set_num_threads(1)


def random_fill(rng, n):
    """A raw binpack problem: some nodes ineligible or without capacity."""
    return dict(
        n_tasks=rng.randint(0, 60),
        eligible=[rng.random() < 0.8 for _ in range(n)],
        capacity=[rng.randint(0, 5) for _ in range(n)],
        penalty=[rng.random() < 0.15 for _ in range(n)],
        svc_count=[rng.randint(0, 4) for _ in range(n)],
        total_count=[rng.randint(0, 6) for _ in range(n)])


@pytest.mark.parametrize("seed", range(4))
def test_plain_fill_matches_oracles(seed):
    """The plain fill on raw problems equals the port's and the JAX
    package's heap oracle and closed form."""
    rng = random.Random(100 + seed)
    for _ in range(25):
        f = random_fill(rng, rng.randint(1, 30))
        g = torch_spread.GroupFill(**f)
        want = torch_spread.binpack_fill(g)
        assert want == torch_spread.binpack_reference(g)
        assert want == jax_spread.binpack_fill(jax_spread.GroupFill(**f))
        cap = [c if e else 0 for c, e in zip(f["capacity"], f["eligible"])]
        got = torch_placement._binpack_fill_plain(
            torch.tensor(np.minimum(cap, f["n_tasks"]), dtype=torch.int32),
            torch.tensor(f["penalty"]),
            torch.tensor(f["svc_count"], dtype=torch.int32),
            torch.tensor(f["total_count"], dtype=torch.int32),
            torch.tensor(f["n_tasks"], dtype=torch.int32))
        assert got.tolist() == want


def binpack_problem(seed, shape):
    """A binpack problem of one of the shapes below, from `seed`."""
    p = jax_problem(seed, strategy="binpack", n_nodes=120, max_tasks=150,
                    tree=shape == "tree")
    G, N = p.extra_mask.shape
    rng = np.random.RandomState(seed)
    if shape == "ports":
        # every group publishes one of two host ports, half cap replicas
        PV = p.port_used0.shape[1]
        gp = np.zeros((G, max(PV, 2)), bool)
        gp[np.arange(G), np.arange(G) % 2] = True
        pu = np.zeros((N, gp.shape[1]), bool)
        pu[:, :PV] = p.port_used0
        pu[::7, 1] = True
        p.group_ports, p.has_ports, p.port_used0 = gp, np.ones(G, bool), pu
        p.max_replicas = np.where(np.arange(G) % 2, 2, 0).astype(np.int32)
    elif shape == "penalty":
        p.penalty = rng.rand(G, N) < 0.3
        p.penalty_nonzero = bool(p.penalty.any())
    elif shape == "vol_topo":
        _with_vol_topo(p, random.Random(seed))
    elif shape == "zero_cap":
        # nodes with no room anywhere in the order, and a group with none
        p.avail_res = p.avail_res.copy()
        p.avail_res[rng.rand(N) < 0.4] = 0
        p.need_res = np.maximum(p.need_res, 1).astype(np.int32)
        p.n_tasks = p.n_tasks.copy()
        p.n_tasks[0] = 0
    return p


def jax_binpack(p):
    G, N = p.extra_mask.shape
    counts, totals, svc = jax_placement.schedule_groups(
        *jax_encode.kernel_args(jax_encode.pad_buckets(p)), strategy=1)
    return (np.asarray(counts)[:G, :N], np.asarray(totals)[:N],
            np.asarray(svc)[:p.svc_count0.shape[0], :N])


def oracle_fills(p):
    """Per group: the GroupFill the CPU oracle solves (the pre-fill state),
    in order, and the counts it gives."""
    static = torch_batch.cpu_static_mask(p)
    totals = p.total0.astype(np.int64).copy()
    svc_counts = p.svc_count0.astype(np.int64).copy()
    avail = p.avail_res.astype(np.int64).copy()
    port_used = p.port_used0.copy()
    out = []
    for gi in range(p.extra_mask.shape[0]):
        svc = svc_counts[p.svc_idx[gi]]
        caps = torch_batch._group_caps(p, gi, avail, svc, port_used)
        g = torch_spread.GroupFill(
            n_tasks=int(p.n_tasks[gi]), eligible=static[gi].tolist(),
            capacity=caps.tolist(), penalty=p.penalty[gi].tolist(),
            svc_count=svc.tolist(), total_count=totals.tolist())
        c = np.array(torch_spread.binpack_fill(g), np.int64)
        out.append((g, c))
        totals += c
        svc_counts[p.svc_idx[gi]] += c
        avail -= c[:, None] * p.need_res[gi][None, :]
        port_used |= p.group_ports[gi][None, :] & (c > 0)[:, None]
    return out


SHAPES = ["plain", "ports", "penalty", "vol_topo", "zero_cap", "tree"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", range(3))
def test_schedule_groups_binpack_matches_jax(seed, shape):
    """schedule_groups(strategy=1): counts, totals and service counts equal
    the JAX package's; counts equal the heap oracle and the closed form
    group by group. Spread preferences ("tree") are ignored."""
    p = binpack_problem(7000 + 10 * seed, shape)
    want = jax_binpack(p)
    got = torch_placement.schedule_groups(
        *convert.kernel_args_from_arrays(jax_encode.kernel_args(p), "cpu"),
        strategy=1, device="cpu")
    for name, w, g in zip(("counts", "totals", "svc_counts"), want, got):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    np.testing.assert_array_equal(want[0], jax_batch.cpu_schedule_encoded(p))
    for gi, (g, c) in enumerate(oracle_fills(p)):
        np.testing.assert_array_equal(want[0][gi], c, err_msg=f"group {gi}")
        assert torch_spread.binpack_reference(g) == c.tolist()
    if shape == "tree":
        assert p.spread_rank.shape[1] >= 2
    if shape == "zero_cap":
        assert want[0][0].sum() == 0


@pytest.mark.parametrize("big", [False, True])
def test_compact_binpack_matches_jax(big):
    p = binpack_problem(7500, "plain")
    arrays = list(jax_encode.kernel_args(p))
    nt = jax_encode.KERNEL_ARG_FIELDS.index("n_tasks")
    if big:
        # n_tasks >= 2^15: the counts stay int32
        arrays[nt] = np.full(p.extra_mask.shape[0], 40_000, np.int32)
    compact = int(arrays[nt].max()) < (1 << 15)
    want = np.asarray(jax_placement.schedule_groups_compact(
        *arrays, compact=compact, strategy=1))
    got = torch_placement.schedule_groups_compact(*arrays, strategy=1,
                                                  device="cpu")
    assert got.dtype == (torch.int32 if big else torch.int16)
    assert str(want.dtype) == ("int32" if big else "int16")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(3))
def test_schedule_encoded_binpack(seed):
    """The port's EncodedProblem through its device backend and its CPU
    oracle, against both JAX backends."""
    p = binpack_problem(7600 + seed, "plain")
    q = convert.encoded_problem_from_arrays(problem_fields(p))
    assert q.strategy == "binpack"
    got = torch_placement.schedule_encoded(q, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, torch_batch.device_schedule_encoded(q, device="cpu"))
    np.testing.assert_array_equal(got, torch_batch.cpu_schedule_encoded(q))
    np.testing.assert_array_equal(got, jax_placement.schedule_encoded(p))
    np.testing.assert_array_equal(got, jax_batch.cpu_schedule_encoded(p))


@pytest.mark.parametrize("seed", range(3))
def test_materialize_orders_match_slot_order(seed):
    """Nodes in INITIAL key order, each node's slots consecutive, with the
    service and total counts carried between groups: equal to
    `binpack_slot_order` and to the JAX package's materialize_orders."""
    p = binpack_problem(7700 + seed, "penalty")
    q = convert.encoded_problem_from_arrays(problem_fields(p))
    counts = torch_batch.cpu_schedule_encoded(q)
    got = torch_batch.materialize_orders(q, counts)
    want = jax_batch.materialize_orders(p, counts)
    totals = q.total0.astype(np.int64).copy()
    svc_counts = q.svc_count0.astype(np.int64).copy()
    for gi, (o, w) in enumerate(zip(got, want)):
        c = counts[gi]
        g = torch_spread.GroupFill(
            n_tasks=int(q.n_tasks[gi]), eligible=[True] * len(c),
            capacity=c.tolist(), penalty=q.penalty[gi].tolist(),
            svc_count=svc_counts[q.svc_idx[gi]].tolist(),
            total_count=totals.tolist())
        assert o.tolist() == torch_spread.binpack_slot_order(g, c.tolist())
        np.testing.assert_array_equal(o, w)
        totals += c
        svc_counts[q.svc_idx[gi]] += c
    assert torch_batch.materialize(q, counts) == jax_batch.materialize(
        p, counts)


@pytest.mark.parametrize("sizes", [
    dict(),
    dict(n_nodes=97, n_groups=6, tasks_per_group=40, n_managers=3,
         log_len=777, seed=9),
])
def test_cluster_step_binpack_matches_jax(sizes):
    jax_inputs = [np.asarray(a)
                  for a in jax_cluster_step.example_inputs(**sizes)]
    counts, totals, commit = jax_cluster_step.cluster_step(*jax_inputs,
                                                           strategy=1)
    ours = torch_cluster_step.example_inputs(**sizes, device="cpu")
    got = torch_cluster_step.cluster_step(*ours, strategy=1, device="cpu")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(counts))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(totals))
    assert int(got[2]) == int(commit)
    spread = torch_cluster_step.cluster_step(*ours, device="cpu")
    assert not torch.equal(spread[0], got[0]), "binpack placed as spread"


@pytest.mark.parametrize("seed", range(2))
def test_padded_groups_and_nodes_change_nothing(seed):
    """The bucket-padded problem (padded groups with no tasks, padded nodes
    not ready, spread levels repeated) places as the unpadded one."""
    p = binpack_problem(7800 + seed, "tree")
    G, N = p.extra_mask.shape
    padded = jax_encode.pad_buckets(p)
    assert padded.extra_mask.shape != (G, N)
    want, _, _ = torch_placement.schedule_groups(
        *jax_encode.kernel_args(p), strategy=1, device="cpu")
    got, _, _ = torch_placement.schedule_groups(
        *jax_encode.kernel_args(padded), strategy=1, device="cpu")
    np.testing.assert_array_equal(got.numpy()[:G, :N], want.numpy())
    assert not got.numpy()[G:].any() and not got.numpy()[:, N:].any()


# ----------------------------------------------------- the resident tick
def binpack_trace(side, seed, steps=6, group_maker=plain_group, tree=False):
    """Churned resident ticks on a binpack encoder: per tick (counts,
    carried state, upload counters), each checked against that side's CPU
    oracle and its carry against the fold."""
    api, _mod, batch = SIDES[side]
    rng = random.Random(seed)
    infos = [make_info(api, rng, i) for i in range(12)]
    next_node_id = 12
    enc = api.encode.IncrementalEncoder(strategy="binpack")
    rp = resident_of(side, enc)
    out = []
    for step in range(steps):
        if step:
            next_node_id = mutate(api, rng, infos, next_node_id, step)
        groups = make_waves(api, rng, step, group_maker)
        if tree:
            groups[0].tasks[0].spec.placement.preferences = [
                api.specs.PlacementPreference(
                    spread_descriptor=f"node.labels.{k}")
                for k in ("zone", "disk", "tier")]
        p = enc.encode(infos, groups, now=NOW)
        assert p.strategy == "binpack"
        if tree:
            assert p.spread_rank.shape[1] == 3      # padded to 4 on the card
        counts = rp.schedule(p)
        np.testing.assert_array_equal(
            counts, batch.cpu_schedule_encoded(p),
            err_msg=f"{side} seed {seed} step {step}")
        st = rp.pull_state()
        assert_fold(st, p, counts, f"{side} seed {seed} step {step}")
        out.append((counts, st, counters(rp)))
        apply_tick(side, enc, rp, infos, p, counts)
    return out


@pytest.mark.parametrize("seed, maker, tree", [
    (80, "quantum", False), (81, "odd", False), (82, "quantum", True)])
def test_resident_binpack_matches_jax(seed, maker, tree):
    """Tick for tick: counts, the eight carried arrays and the four upload
    counters equal the JAX ResidentPlacement's binpack tick. Odd
    reservations ship correction rows; the tree case carries three spread
    levels (padded to four), which binpack must ignore."""
    group_maker = odd_group if maker == "odd" else plain_group
    want = binpack_trace("jax", seed, group_maker=group_maker, tree=tree)
    got = binpack_trace("torch", seed, group_maker=group_maker, tree=tree)
    for step, ((wc, ws, wn), (gc, gs, gn)) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(gc, wc, err_msg=f"step {step}")
        assert_states_equal(gs, ws, f"step {step}")
        assert gn == wn, f"step {step}: counters {gn} != {wn}"
    assert sum(c.sum() for c, _s, _n in got) > 0


def test_binpack_consolidates_where_spread_spreads():
    """The strategies differ where they should: binpack fills the fullest
    nodes first, spread balances the same wave over more nodes."""
    infos, _ = random_cluster(TORCH_API, 5, n_nodes=8, n_groups=0)
    for info in infos:
        info.node.status.state = TORCH_API.types.NodeStatusState.READY
        info.node.spec.availability = TORCH_API.types.NodeAvailability.ACTIVE
    group = service_group(TORCH_API, "svc-a", 1, 6)
    res = {}
    for strategy in ("binpack", "spread"):
        p = TORCH_API.encode.encode(infos, [group], strategy=strategy)
        res[strategy] = torch_placement.schedule_encoded(p, device="cpu")[0]
        np.testing.assert_array_equal(
            res[strategy], torch_batch.cpu_schedule_encoded(p)[0])
    assert res["binpack"].sum() == res["spread"].sum() == 6
    assert (res["binpack"] > 0).sum() < (res["spread"] > 0).sum()
