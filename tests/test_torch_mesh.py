"""The port's one-shot mesh path against the JAX package on the CPU.

`swarmkit_tpu_torch.parallel.mesh` splits the node axis into k shards on one
device; with `make_mesh(k, device="cpu")` every sharded kernel runs its
plain PyTorch version (cross-shard sums written out, the boundary sort's
gather). The same numpy-made inputs go to the JAX package on the conftest's
8 virtual CPU devices: problems are built with the JAX encoder and handed to
the port through `convert.encoded_problem_from_arrays`. Counts and commit
indices are integers, so the tolerance is exact equality.

Covered: the sharded placement (N not divisible by k, N < k: whole shards
of phantom nodes; spread, tree, topology and binpack), the manager-axis
tally, the fused step with its log-axis commit (E not divisible by k),
`synth_shard_cluster` field for field, the sampled-shard oracle and the
invariant sweep (`parallel/shard_parity.py`), the chunked upload, the
2^31 refusal of the one-device entries, and the raise without a card.
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

from swarmkit_tpu.models import cluster_step as jax_cluster_step
from swarmkit_tpu.ops import raft_replay as jax_replay
from swarmkit_tpu.parallel import mesh as jax_mesh
from swarmkit_tpu.scheduler import encode as jax_encode
from swarmkit_tpu_torch import convert
from swarmkit_tpu_torch.models import cluster_step as torch_cluster_step
from swarmkit_tpu_torch.ops import placement as torch_placement
from swarmkit_tpu_torch.ops import raft_replay as torch_replay
from swarmkit_tpu_torch.parallel import fill as torch_fill
from swarmkit_tpu_torch.parallel import mesh as torch_mesh
from swarmkit_tpu_torch.parallel import shard_parity as torch_parity
from swarmkit_tpu_torch.scheduler import batch as torch_batch
from swarmkit_tpu_torch.scheduler import encode as torch_encode
from test_placement_parity import random_cluster as jax_random_cluster
from test_torch_placement import TORCH_API, random_cluster

torch.set_num_threads(1)


def cpu_mesh(k, axis=torch_mesh.NODE_AXIS):
    return torch_mesh.make_mesh(k, axis=axis, device="cpu")


def to_port(p):
    """The port's EncodedProblem with the JAX problem's arrays."""
    return convert.encoded_problem_from_arrays(
        {f.name: getattr(p, f.name) for f in dataclasses.fields(p)})


def log_acks(managers, log_len, seed, low=100):
    """Each manager acked a prefix of the log (random frontiers)."""
    acks = np.zeros((managers, log_len), bool)
    frontier = np.random.RandomState(seed).randint(low, log_len, managers)
    for m in range(managers):
        acks[m, :frontier[m]] = True
    return acks, frontier


@pytest.mark.parametrize("strategy", ["spread", "binpack"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_placement_matches_jax(seed, strategy):
    """test_parallel.py::test_sharded_placement_matches_oracle's problems:
    37 nodes over 8 shards (3 phantom nodes), against JAX
    `sharded_schedule` and the port's CPU oracle."""
    infos, groups = jax_random_cluster(random.Random(seed), n_nodes=37,
                                       n_groups=4)
    p = jax_encode.encode(infos, groups, strategy=strategy)
    want = jax_mesh.sharded_schedule(p, jax_mesh.make_mesh(8))
    q = to_port(p)
    got = torch_mesh.sharded_schedule(q, cpu_mesh(8))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, torch_batch.cpu_schedule_encoded(q))


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("n_nodes", [37, 5])
@pytest.mark.parametrize("shape", ["flat", "tree", "topology", "binpack"])
def test_shard_counts_equal_one_device(k, n_nodes, shape):
    """Any k, N not divisible by k and N < k (whole shards of phantom
    nodes): the sharded counts, and every shard's folded state, equal the
    port's one-device `schedule_groups` on the CPU."""
    infos, groups = random_cluster(TORCH_API, 40 + n_nodes, n_nodes=n_nodes,
                                   n_groups=5, max_tasks=30,
                                   tree=shape == "tree")
    strategy = {"topology": "topology", "binpack": "binpack"}.get(shape,
                                                                  "spread")
    p = torch_encode.encode(infos, groups, strategy=strategy,
                            topology="node.labels.zone"
                            if shape == "topology" else None)
    if shape == "flat":
        G, _, N = p.spread_rank.shape
        p.spread_rank = np.zeros((G, 0, N), np.int32)
    s = 1 if strategy == "binpack" else 0
    counts, totals, svc = torch_placement.schedule_groups(
        *torch_encode.kernel_args(p), strategy=s, device="cpu")
    args, N = torch_mesh.shard_problem(p, cpu_mesh(k))
    shards, flags, states = torch_fill.sharded_schedule_core(args, s)
    assert not flags.any()
    np.testing.assert_array_equal(torch.cat(shards, 1)[:, :N], counts)
    np.testing.assert_array_equal(
        torch.cat([st.totals for st in states])[:N], totals)
    np.testing.assert_array_equal(
        torch.cat([st.svc_counts for st in states], 1)[:, :N], svc)
    np.testing.assert_array_equal(
        torch_mesh.sharded_schedule(p, cpu_mesh(k)), counts.numpy())


def test_sharded_replay_commit_matches_jax():
    """test_parallel.py::test_sharded_replay_commit: 8 managers x 4,096
    entries, one manager a shard; M not divisible by k raises."""
    rng = np.random.RandomState(42)
    acks = rng.rand(8, 4096) < 0.7
    acks[:, :50] = True
    jm = jax_mesh.make_mesh(8, axis="managers")
    with jax_mesh.mesh_context(jm):
        want, want_mask = jax_replay.sharded_replay_commit(jm, "managers")(
            acks, 5)
    fn = torch_replay.sharded_replay_commit(cpu_mesh(8, "managers"))
    got, got_mask = fn(acks, 5)
    assert int(got) == int(want) >= 50
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(got_mask.numpy(),
                                  np.arange(4096) < int(want))
    two = torch_replay.sharded_replay_commit(cpu_mesh(2, "managers"))
    assert int(two(acks, 5)[0]) == int(want)
    with pytest.raises(ValueError, match="do not split"):
        fn(acks[:6], 4)
    with pytest.raises(ValueError, match="axis"):
        torch_replay.sharded_replay_commit(cpu_mesh(8), "managers")


@pytest.mark.parametrize("layout", ["managers", "log"])
def test_sharded_tally_layouts(layout):
    """Both layouts of the sharded tally against the one-device
    `replay_commit`, with a hole in a middle shard and with none."""
    rng = np.random.RandomState(3)
    acks = rng.rand(4, 64) < 0.97
    for full in (False, True):
        a = np.ones_like(acks) if full else acks
        want = int(torch_replay.replay_commit(torch.from_numpy(a), 3)[0])
        t = torch.from_numpy(a)
        shards = list(torch.split(t, 1 if layout == "managers" else 16,
                                  dim=0 if layout == "managers" else 1))
        commit, committed = torch_replay.sharded_replay_tally(
            [s.contiguous() for s in shards], 3, layout)
        assert int(commit) == want
        flat = committed if layout == "managers" else torch.cat(committed)
        np.testing.assert_array_equal(flat.numpy(), np.arange(64) < want)


def test_fused_step_matches_jax():
    """test_parallel.py::test_fused_cluster_step_sharded_parity with a log
    of 4,099 entries (not divisible by 8): the fused step's counts and
    commit equal JAX `sharded_cluster_step`, the oracle and the sorted
    frontier rule."""
    infos, groups = jax_cluster_step.example_cluster(
        n_nodes=8 * 16 + 3, n_groups=9, tasks_per_group=24)
    p = jax_encode.encode(infos, groups)
    assert p.spread_rank.shape[1] >= 2
    managers, log_len = 5, 4099
    acks, frontier = log_acks(managers, log_len, 2)
    quorum = managers // 2 + 1
    want, want_commit = jax_mesh.sharded_cluster_step(
        p, acks, np.int32(quorum), jax_mesh.make_mesh(8))
    q = to_port(p)
    stats = {}
    got, commit = torch_mesh.sharded_cluster_step(
        q, acks, np.int32(quorum), cpu_mesh(8), stats=stats)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, torch_batch.cpu_schedule_encoded(q))
    assert commit == want_commit == int(np.sort(frontier)[managers - quorum])
    assert set(stats) == {"h2d_bytes", "upload_s", "fill_s", "pull_s",
                          "d2h_bytes"}
    assert stats["d2h_bytes"] == got.nbytes
    # every entry acked: the padding's hole is the commit (E itself)
    full, full_commit = torch_mesh.sharded_cluster_step(
        q, np.ones((3, 13), bool), 2, cpu_mesh(8))
    assert full_commit == 13
    np.testing.assert_array_equal(full, got)


@pytest.mark.parametrize("strategy", ["spread", "binpack", "topology"])
def test_synth_shard_cluster_equals_jax(strategy):
    kw = dict(groups_per_shard=2, tasks_per_group=50, seed=5, lmax=2,
              strategy=strategy)
    p, gshard = jax_cluster_step.synth_shard_cluster(8 * 24, 8, **kw)
    q, qshard = torch_cluster_step.synth_shard_cluster(8 * 24, 8, **kw)
    np.testing.assert_array_equal(qshard, gshard)
    for f in dataclasses.fields(p):
        a, b = getattr(p, f.name), getattr(q, f.name)
        if isinstance(a, np.ndarray):
            assert b.dtype == a.dtype and b.shape == a.shape, f.name
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert b == a, f.name
    # the spread table stays a broadcast view of one [L, N] tree
    assert q.spread_rank.strides[0] == 0
    flat, _ = torch_cluster_step.synth_shard_cluster(
        8 * 4, 8, seed=1, lmax=0, with_ports=False, with_voltopo=False)
    jflat, _ = jax_cluster_step.synth_shard_cluster(
        8 * 4, 8, seed=1, lmax=0, with_ports=False, with_voltopo=False)
    for name in torch_encode.KERNEL_ARG_FIELDS:
        np.testing.assert_array_equal(getattr(flat, name),
                                      getattr(jflat, name), err_msg=name)


@pytest.mark.parametrize("strategy", ["binpack", "topology"])
def test_synth_strategy_sampled_parity(strategy):
    """test_mesh_scaleout.py::test_synth_strategy_sampled_parity: the
    sliced oracle on every shard, the invariant sweep, and JAX's counts."""
    kw = dict(groups_per_shard=2, tasks_per_group=100, seed=3, lmax=2,
              strategy=strategy)
    p, gshard = torch_cluster_step.synth_shard_cluster(8 * 32, 8, **kw)
    assert p.strategy == strategy
    counts = torch_mesh.sharded_schedule(p, cpu_mesh(8))
    np.testing.assert_array_equal(counts, torch_batch.cpu_schedule_encoded(p))
    jp, _ = jax_cluster_step.synth_shard_cluster(8 * 32, 8, **kw)
    np.testing.assert_array_equal(
        counts, jax_mesh.sharded_schedule(jp, jax_mesh.make_mesh(8)))
    checked = torch_parity.sampled_shard_parity(p, counts, gshard, 8,
                                                list(range(8)))
    assert checked == list(range(8))
    torch_parity.check_fill_invariants(p, counts)


def test_chunked_shard_problem_matches_plain():
    """test_mesh_scaleout.py::test_chunked_shard_problem_matches_plain:
    every array uploaded shard by shard (chunked=1) equals the padded
    whole-array upload, shard for shard."""
    infos, groups = jax_random_cluster(random.Random(3), n_nodes=53,
                                       n_groups=4)
    q = to_port(jax_encode.encode(infos, groups))
    mesh = cpu_mesh(8)
    plain, N = torch_mesh.shard_problem(q, mesh)
    stats = {}
    chunked, N2 = torch_mesh.shard_problem(q, mesh, stats=stats, chunked=1)
    assert N == N2 == 53
    padded = sum(np.asarray(a).nbytes * (56 if torch_mesh._FIELD_SHARDING[
        f][0] is not None else 53) // 53 for f, a in zip(
        torch_encode.KERNEL_ARG_FIELDS, torch_encode.kernel_args(q)))
    assert stats["h2d_bytes"] == padded
    for field, a, b in zip(torch_encode.KERNEL_ARG_FIELDS, plain, chunked):
        if torch_mesh._FIELD_SHARDING[field][0] is None:
            assert torch.equal(a, b), field
        else:
            assert len(a) == len(b) == 8, field
            for x, y in zip(a, b):
                assert torch.equal(x, y), field
    counts = torch_mesh.sharded_schedule(q, mesh)
    np.testing.assert_array_equal(counts, torch_batch.cpu_schedule_encoded(q))


def test_synth_shard_cluster_sampled_parity_agrees_with_full_oracle():
    """test_mesh_scaleout.py's check of the methodology: at a size where
    the full oracle still runs, the sampled-shard oracle agrees with it on
    every shard; the fused step's commit equals `replay_commit`."""
    p, gshard = torch_cluster_step.synth_shard_cluster(
        8 * 64, 8, groups_per_shard=2, tasks_per_group=300, seed=7, lmax=2)
    acks, _ = log_acks(5, 2048, 5)
    stats = {}
    counts, commit = torch_mesh.sharded_cluster_step(
        p, acks, np.int32(3), cpu_mesh(8), stats=stats)
    assert commit == int(torch_replay.replay_commit(torch.from_numpy(acks),
                                                    3)[0])
    np.testing.assert_array_equal(counts, torch_batch.cpu_schedule_encoded(p))
    checked = torch_parity.sampled_shard_parity(p, counts, gshard, 8,
                                                list(range(8)))
    assert checked == list(range(8))
    info = torch_parity.check_fill_invariants(p, counts)
    assert 0 < info["placed"] <= info["tasks"]
    assert stats["h2d_bytes"] > 0 and stats["fill_s"] > 0


def test_invariant_checker_rejects_corrupt_fills():
    """test_mesh_scaleout.py::test_invariant_checker_rejects_corrupt_fills
    on the port's checker."""
    p, gshard = torch_cluster_step.synth_shard_cluster(
        8 * 16, 8, groups_per_shard=1, tasks_per_group=40, seed=1, lmax=1)
    counts = torch_mesh.sharded_schedule(p, cpu_mesh(8))
    torch_parity.check_fill_invariants(p, counts)

    bad = counts.copy()
    bad[0, np.flatnonzero(gshard != 0)[0] * 16] += 1  # wrong shard's node
    with pytest.raises(AssertionError):
        torch_parity.check_fill_invariants(p, bad)
    with pytest.raises(AssertionError):
        torch_parity.sampled_shard_parity(p, bad, gshard, 8, [int(gshard[0])])

    bad2 = counts.copy()
    bad2[0] += 10_000          # overcommit + conservation violation
    with pytest.raises(AssertionError):
        torch_parity.check_fill_invariants(p, bad2)


def _open_problem(n_tasks, strategy):
    """16 nodes and 2 groups with no constraint, resource, cap or port:
    group g's capacity sum is 16 * n_tasks[g]."""
    p = torch_encode.encode(*torch_cluster_step.example_cluster(16, 2, 4),
                            strategy=strategy)
    p.ready = np.ones_like(p.ready)
    p.extra_mask = np.ones_like(p.extra_mask)
    p.constraints = np.full_like(p.constraints, -1)
    p.plat_req = np.full_like(p.plat_req, -2)
    p.req_plugins = np.zeros_like(p.req_plugins)
    p.need_res = np.zeros_like(p.need_res)
    p.max_replicas = np.zeros_like(p.max_replicas)
    p.has_ports = np.zeros_like(p.has_ports)
    p.n_tasks = np.asarray(n_tasks, np.int32)
    return p


@pytest.mark.parametrize("strategy", ["spread", "binpack"])
def test_capacity_sum_of_2_31_is_refused(strategy):
    """F1's rule on the mesh: a group whose capacity sum over all shards
    reaches 2^31 (16 x 2^27) places and folds nothing and raises, as the
    one-device `schedule_groups` refuses it; the next group places as if
    it had no tasks."""
    s = 1 if strategy == "binpack" else 0
    p = _open_problem([1 << 27, 4], strategy)
    with pytest.raises(ValueError, match="groups \\[0\\].*2\\^31"):
        torch_placement.schedule_groups(*torch_encode.kernel_args(p),
                                         strategy=s, device="cpu")
    with pytest.raises(ValueError, match="groups \\[0\\].*2\\^31"):
        torch_mesh.sharded_schedule(p, cpu_mesh(8))
    args, _ = torch_mesh.shard_problem(p, cpu_mesh(8))
    shards, flags, states = torch_fill.sharded_schedule_core(args, s)
    assert flags.tolist() == [1, 0]
    q = _open_problem([0, 4], strategy)
    want_shards, want_flags, want_states = torch_fill.sharded_schedule_core(
        torch_mesh.shard_problem(q, cpu_mesh(8))[0], s)
    assert want_flags.tolist() == [0, 0]
    for a, b in zip(shards, want_shards):
        assert torch.equal(a, b)
    for st, want in zip(states, want_states):
        for a, b in zip(st, want):
            assert torch.equal(a, b)
    # just below: 16 x (2^27 - 1) places every task
    ok = torch_mesh.sharded_schedule(_open_problem([(1 << 27) - 1, 4],
                                                   strategy), cpu_mesh(8))
    assert ok.sum(axis=1).tolist() == [(1 << 27) - 1, 4]


def test_mesh_entries_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p, _ = torch_cluster_step.synth_shard_cluster(8 * 4, 8, seed=1)
    acks = np.ones((3, 16), bool)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_mesh.sharded_schedule(p, torch_mesh.make_mesh(8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_mesh.sharded_cluster_step(p, acks, 2, torch_mesh.make_mesh(8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_replay.sharded_replay_commit(
            torch_mesh.make_mesh(8, axis="managers"))
    assert torch_mesh.make_mesh(8, device="cpu").size == 8


def test_sharded_wrappers_refuse_mixed_shards():
    """Shards must lie on one device and be shaped alike; the group-side
    tables must be one replicated copy."""
    p, _ = torch_cluster_step.synth_shard_cluster(8 * 4, 2, seed=1)
    args, _ = torch_mesh.shard_problem(p, cpu_mesh(2))
    with pytest.raises(ValueError, match="tensors on"):
        torch_replay.sharded_replay_tally(
            [torch.ones((2, 4), dtype=torch.bool),
             torch.ones((2, 4), dtype=torch.bool, device="meta")], 1)
    with pytest.raises(ValueError, match="unknown layout"):
        torch_replay.sharded_replay_tally(
            [torch.ones((2, 4), dtype=torch.bool)], 1, "nodes")
    with pytest.raises(ValueError, match="unknown strategy"):
        torch_fill.sharded_schedule_core(args, 2)
