"""The sharded kernels of the one-shot mesh path (K20-K22) against their
plain PyTorch versions on the card. Every test here is marked `gpu` and
skips without a CUDA device; the file imports neither JAX nor the JAX
package, so on a machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_mesh.py

Outputs are integer or bool: the tolerance is exact equality.
"""
import numpy as np
import pytest
import torch

from swarmkit_tpu_torch.models import cluster_step as torch_cluster_step
from swarmkit_tpu_torch.ops import _kernels
from swarmkit_tpu_torch.ops import placement as torch_placement
from swarmkit_tpu_torch.ops import raft_replay as torch_replay
from swarmkit_tpu_torch.parallel import fill as torch_fill
from swarmkit_tpu_torch.parallel import mesh as torch_mesh
from swarmkit_tpu_torch.scheduler import encode as torch_encode

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def example(n_nodes, n_groups, tasks, strategy, seed=0):
    """The example cluster (LMAX 3 with 12 groups or more), with seeded
    load so that the pours have service counts to level."""
    rng = np.random.RandomState(seed)
    p = torch_encode.encode(
        *torch_cluster_step.example_cluster(n_nodes, n_groups, tasks, seed),
        strategy=strategy)
    p.total0 = rng.randint(0, 9, p.total0.shape).astype(np.int32)
    p.svc_count0 = (rng.rand(*p.svc_count0.shape) < 0.3).astype(np.int32) \
        * rng.randint(1, 5, p.svc_count0.shape).astype(np.int32)
    p.penalty = rng.rand(*p.penalty.shape) < 0.05
    return p


def synth(n_nodes, lmax, strategy, tasks=400):
    p, _ = torch_cluster_step.synth_shard_cluster(
        n_nodes, 8, groups_per_shard=2, tasks_per_group=tasks, seed=4,
        lmax=lmax, strategy=strategy)
    return p


PROBLEMS = {
    "example L3 spread": lambda: example(251, 12, 40, "spread"),
    "example L3 topology": lambda: example(251, 12, 40, "spread", seed=1),
    "example binpack": lambda: example(251, 12, 40, "binpack"),
    "synth L0 spread": lambda: synth(8 * 40, 0, "spread"),
    "synth L2 topology": lambda: synth(8 * 40, 2, "topology"),
    "synth L2 binpack": lambda: synth(8 * 40, 2, "binpack"),
    "medium example L3": lambda: example(4003, 16, 900, "spread"),
    "medium synth L2": lambda: synth(8 * 2048, 2, "spread", tasks=6000),
    "medium synth binpack": lambda: synth(8 * 2048, 2, "binpack",
                                          tasks=6000),
}


def _run(p, k, device):
    strategy = 1 if p.strategy == "binpack" else 0
    args, N = torch_mesh.shard_problem(p, torch_mesh.make_mesh(k,
                                                               device=device))
    counts, flags, states = torch_fill.sharded_schedule_core(args, strategy)
    return (torch.cat(counts, 1)[:, :N].cpu(), flags.cpu(),
            [torch.cat([getattr(s, f) for s in states],
                       0 if f != "svc_counts" else 1).cpu()
             for f in ("totals", "svc_counts", "avail", "port_used")])


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_sharded_fill_equals_plain(cuda, name, k):
    """K1 a shard, then K20 (spread, topology; L = 0, 2, 3) or K21
    (binpack) a group: counts, flags and every shard's folded state equal
    the plain versions on the CPU and the one-device counts."""
    p = PROBLEMS[name]()
    wf0 = torch_fill.sharded_water_fill_step.launches
    bf0 = torch_fill.sharded_binpack_fill_step.launches
    got, g_flags, g_state = _run(p, k, cuda)
    want, w_flags, w_state = _run(p, k, "cpu")
    assert torch.equal(got, want)
    assert torch.equal(g_flags, w_flags) and not g_flags.any()
    for a, b in zip(g_state, w_state):
        assert torch.equal(a, b)
    G = p.n_tasks.shape[0]
    if p.strategy == "binpack":
        assert torch_fill.sharded_binpack_fill_step.launches - bf0 == G
    else:
        assert torch_fill.sharded_water_fill_step.launches - wf0 == G
    one, _, _ = torch_placement.schedule_groups(
        *torch_encode.kernel_args(p),
        strategy=1 if p.strategy == "binpack" else 0, device=cuda)
    assert torch.equal(got, one.cpu())
    assert int(got.sum()) > 0


@pytest.mark.parametrize("k", [1, 3, 8])
def test_fused_step_commit_with_padding(cuda, k):
    """The fused step's log-split commit (K22) with E not divisible by k,
    a hole in a middle shard, and no hole at all, equals the plain version
    and the one-device replay_commit."""
    p = synth(8 * 40, 2, "spread")
    rng = np.random.RandomState(k)
    for E, full in ((4099, False), (1 << 15, False), (1001, True)):
        acks = np.zeros((5, E), bool)
        for m, f in enumerate(rng.randint(E // 3, E, 5)):
            acks[m, :f] = True
        if full:
            acks[:] = True
        c_counts, c_commit = torch_mesh.sharded_cluster_step(
            p, acks, 3, torch_mesh.make_mesh(k, device=cuda))
        p_counts, p_commit = torch_mesh.sharded_cluster_step(
            p, acks, 3, torch_mesh.make_mesh(k, device="cpu"))
        want = int(torch_replay.replay_commit(
            torch.from_numpy(acks).to(cuda), 3)[0])
        assert c_commit == p_commit == want
        np.testing.assert_array_equal(c_counts, p_counts)


@pytest.mark.parametrize("layout", ["managers", "log"])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_sharded_tally_equals_plain(cuda, layout, k):
    rng = np.random.RandomState(k)
    acks = rng.rand(8, 8 * 4096) < 0.9995
    acks[:, :100] = True
    t = torch.from_numpy(acks)
    dim = 0 if layout == "managers" else 1
    parts = [s.contiguous() for s in torch.split(t, t.shape[dim] // k, dim)]
    n0 = torch_replay.sharded_replay_tally.launches
    got, g_mask = torch_replay.sharded_replay_tally(
        [s.to(cuda) for s in parts], 5, layout)
    assert torch_replay.sharded_replay_tally.launches == n0 + 1
    want, w_mask = torch_replay.sharded_replay_tally(parts, 5, layout)
    assert int(got) == int(want) >= 100
    if layout == "log":
        g_mask, w_mask = torch.cat(g_mask), torch.cat(w_mask)
    assert torch.equal(g_mask.cpu(), w_mask)
    fn = torch_replay.sharded_replay_commit(
        torch_mesh.make_mesh(8, axis="managers", device=cuda))
    assert int(fn(acks, 5)[0]) == int(torch_replay.replay_commit(t, 5)[0])


@pytest.mark.parametrize("strategy", ["spread", "binpack"])
def test_too_many_shards_raise(cuda, strategy):
    """A shard count the card cannot hold co-resident is refused at the
    launch (no fallback, no hang)."""
    s = 1 if strategy == "binpack" else 0
    most = torch_fill.max_shards(s)
    assert most >= 8
    p = synth(8 * 40, 2, strategy)
    with pytest.raises(_kernels.KernelLaunchError):
        torch_mesh.sharded_schedule(
            p, torch_mesh.make_mesh(most + 1, device=cuda))


def test_shards_on_two_devices_raise(cuda):
    """Exchange between cards is not written: a shard on another device
    raises in K20, K21 and K22, as does K1's mixed input."""
    p = synth(8 * 40, 2, "spread")
    args, _ = torch_mesh.shard_problem(p, torch_mesh.make_mesh(2,
                                                               device=cuda))
    tables, states, nb = torch_fill.fill_inputs(args)
    states[1] = torch_placement.FillState(*(x.cpu() for x in states[1]))
    for strategy in (0, 1):
        with pytest.raises(ValueError, match="tensors on"):
            torch_fill.sharded_fill(tables, states, strategy, nb)
    mixed = list(args)
    mixed[0] = [args[0][0], args[0][1].cpu()]          # ready, shard 1
    with pytest.raises(ValueError, match="tensors on"):
        torch_fill.sharded_schedule_core(tuple(mixed), 0)
    acks = torch.ones((2, 64), dtype=torch.bool)
    with pytest.raises(ValueError, match="tensors on"):
        torch_replay.sharded_replay_tally([acks.to(cuda), acks], 2, "log")


def test_default_branch_bound(cuda):
    """K20 without the launch loop's branch bound walks every slot below
    the padded node count, and places and folds the same."""
    p = example(251, 12, 40, "spread")
    args, _ = torch_mesh.shard_problem(p, torch_mesh.make_mesh(8,
                                                               device=cuda))
    tables, s_bound, nb = torch_fill.fill_inputs(args)
    _, s_all, _ = torch_fill.fill_inputs(args)
    assert nb < 8 * 32
    c_bound, f_bound = torch_fill.sharded_fill(tables, s_bound, 0, nb)
    c_all, f_all = torch_fill.sharded_fill(tables, s_all, 0)
    assert torch.equal(f_bound, f_all)
    for a, b in zip(c_bound, c_all):
        assert torch.equal(a, b)
    for a, b in zip(s_bound, s_all):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
