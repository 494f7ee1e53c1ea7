"""The placement's int32 contract in the PyTorch port, against the JAX
package on the CPU.

Every int32 sum of a group step is bounded by the group's capacity sum, the
sum over its eligible nodes of min(cap, n_tasks), so the reference is exact
while that sum stays below 2^31; the port refuses a group only from there
(its steps flag it, and the entries raise when they read the flags with the
counts). The two inputs below are placeable: N * max(n_tasks) reaches 2^31
on both (the padded node bucket alone does it on the first), while each
capacity sum is a few hundred thousand. Both must place every task, equal
to the JAX package and to the CPU oracle; counts are integers, so the
tolerance is exact equality.

  * the resident tick: 65,537 nodes (padded to 131,072 on the card) and one
    service of 16,384 one-quantum tasks;
  * the one-shot entry: 20,000 nodes and one service of 131,072 tasks.

The same two shapes run on the card in tests/test_torch_gpu_int32_guard.py
(which imports no JAX) and in chip_smoke.py. The steps' flag and the
resident tick's read of it are held here too. Both repros build 2 x
16,384 and 2 x 131,072 task objects, which is most of their ~20 s; the
node counts are the repros' own (a smaller one-shot cluster would save
nothing).
"""
import random

import numpy as np
import pytest
import torch

from swarmkit_tpu.ops import resident as jax_resident
from swarmkit_tpu.scheduler import batch as jax_batch
from swarmkit_tpu_torch.convert import to_kernel_tensors
from swarmkit_tpu_torch.models import cluster_step as torch_cluster_step
from swarmkit_tpu_torch.ops import placement as torch_placement
from swarmkit_tpu_torch.ops import resident as torch_resident
from swarmkit_tpu_torch.scheduler import batch as torch_batch
from test_torch_placement import JAX_API, TORCH_API
from test_torch_resident import make_info, service_group

torch.set_num_threads(1)

RESIDENT = (65_537, 16_384)      # nodes, tasks: the resident repro
ONE_SHOT = (20_000, 131_072)     # nodes, tasks: the one-shot repro


def problem(api, n_nodes, n_tasks):
    """The encoded cluster of `random.Random(0)` nodes and one service."""
    rng = random.Random(0)
    infos = [make_info(api, rng, i) for i in range(n_nodes)]
    enc = api.encode.IncrementalEncoder()
    return enc, enc.encode(infos, [service_group(api, "svc-big", 1,
                                                 n_tasks)])


def test_resident_tick_places_past_the_old_guard():
    n_nodes, n_tasks = RESIDENT
    enc, p = problem(TORCH_API, n_nodes, n_tasks)
    assert 2 * n_nodes > 1 << 16     # the padded bucket is 131,072
    got = torch_resident.ResidentPlacement(enc, device="cpu").schedule(p)
    jenc, jp = problem(JAX_API, n_nodes, n_tasks)
    want = jax_resident.ResidentPlacement(jenc).schedule(jp)
    assert int(got.sum()) == n_tasks
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, torch_batch.cpu_schedule_encoded(p))


def test_one_shot_places_past_the_old_guard():
    n_nodes, n_tasks = ONE_SHOT
    _, p = problem(TORCH_API, n_nodes, n_tasks)
    assert n_nodes * n_tasks >= 1 << 31
    got = torch_batch.device_schedule_encoded(p, device="cpu")
    _, jp = problem(JAX_API, n_nodes, n_tasks)
    assert int(got.sum()) == n_tasks
    np.testing.assert_array_equal(got, jax_batch.tpu_schedule_encoded(jp))
    np.testing.assert_array_equal(got, torch_batch.cpu_schedule_encoded(p))


def _open_inputs(n_tasks):
    """16 nodes, 2 groups, every node eligible for both at capacity
    min(UNLIMITED, n_tasks[g]): group g's capacity sum is 16 * n_tasks[g]."""
    args = list(torch_cluster_step.example_inputs(
        n_nodes=16, n_groups=2, tasks_per_group=4, device="cpu")[2:])
    args[0].fill_(True)
    args[4].fill_(True)
    args[5].fill_(-1)
    args[6].fill_(-2)
    args[7].zero_()
    args[13].zero_()
    args[14].zero_()
    args[16].zero_()
    args[11] = torch.tensor(n_tasks, dtype=torch.int32)
    return to_kernel_tensors(args, "cpu")


def _core(a, strategy):
    state = torch_placement.FillState(a[9].clone(), a[10].clone(),
                                      a[8].clone(), a[18].clone())
    counts, flags = torch_placement.schedule_core(
        *a[:8], a[20], *a[11:18], a[19], state, strategy)
    return counts, flags, state


@pytest.mark.parametrize("strategy", [0, 1])
def test_steps_flag_an_overflowing_group_and_fold_nothing(strategy):
    """Group 0's capacity sum is 16 * 2^27 = 2^31: its step sets the flag,
    places nothing and folds nothing; group 1 places as if group 0 had no
    tasks."""
    counts, flags, state = _core(_open_inputs([1 << 27, 4]), strategy)
    assert flags.tolist() == [1, 0]
    assert int(counts[0].abs().sum()) == 0
    want_counts, want_flags, want_state = _core(_open_inputs([0, 4]),
                                                strategy)
    assert want_flags.tolist() == [0, 0]
    assert torch.equal(counts, want_counts)
    for a, b in zip(state, want_state):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="groups \\[0\\].*2\\^31"):
        torch_placement.raise_on_overflow(flags)


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_pending_counts_raise_on_a_flag(form):
    """The resident tick reads the flags with the counts, in the same copy:
    a set flag raises (after marking the carry stale), a clear one does
    not."""
    counts = torch.tensor([[0, 2, 1], [3, 0, 0]], dtype=torch.int32)
    refused = []
    for flags, raises in ((torch.tensor([0, 1], dtype=torch.int32), True),
                          (torch.zeros(2, dtype=torch.int32), False)):
        if form == "dense":
            h = torch_resident.PendingCounts(
                (counts.to(torch.int16), flags),
                on_refuse=lambda: refused.append(1))
        else:
            idx, vals = torch_resident.sparse_counts_plain(counts, 2, 3, 4,
                                                           True)
            h = torch_resident.PendingCounts(
                (idx, vals, flags), (2, 3),
                on_refuse=lambda: refused.append(1))
        if raises:
            for _ in range(2):          # every read of a refused tick raises
                with pytest.raises(ValueError, match="2\\^31"):
                    h.get()
            assert refused == [1, 1]
        else:
            np.testing.assert_array_equal(h.get(), counts.numpy())
