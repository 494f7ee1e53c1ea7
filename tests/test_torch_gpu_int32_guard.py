"""The placement's int32 contract on the card. Every test here is marked
`gpu` and skips without a CUDA device; the file imports neither JAX nor the
JAX package, so on a machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_int32_guard.py

The two shapes of tests/test_torch_int32_guard.py, on the port's own
example cluster (the JAX-side generators stay on the CPU): a resident tick
at 65,537 nodes (padded to 131,072 on the card) with one service of 16,384
tasks, and the one-shot entry at 20,000 nodes with one service of 131,072
tasks. N * max(n_tasks) reaches 2^31 on both, the capacity sums do not:
every task is placed, equal to the CPU oracle. Then the overflow flag of
K2, K3 and K9 against their plain versions. Exact equality throughout.
"""
import numpy as np
import pytest
import torch

from swarmkit_tpu_torch.convert import to_kernel_tensors
from swarmkit_tpu_torch.models import cluster_step as torch_cluster_step
from swarmkit_tpu_torch.ops import placement as torch_placement
from swarmkit_tpu_torch.ops import resident as torch_resident
from swarmkit_tpu_torch.scheduler import batch as torch_batch
from swarmkit_tpu_torch.scheduler import encode as torch_encode

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def service_group(n_tasks):
    """One service, no constraints or preferences, one CPU quantum a task
    (tests/test_torch_resident.py `service_group`)."""
    from swarmkit_tpu_torch.api import objects, types

    tasks = []
    for ti in range(n_tasks):
        t = objects.Task(id=f"pt-svc-big-v1-{ti:06d}", service_id="svc-big",
                         slot=ti + 1)
        t.desired_state = types.TaskState.RUNNING
        t.status.state = types.TaskState.PENDING
        tasks.append(t)
    spec = tasks[0].spec
    spec.resources.reservations.nano_cpus = torch_encode.CPU_QUANTUM
    spec.resources.reservations.memory_bytes = 0
    for t in tasks[1:]:
        t.spec = spec
    return torch_encode.TaskGroup(service_id="svc-big", spec_version=1,
                                  tasks=tasks)


def _infos(n_nodes):
    infos, _ = torch_cluster_step.example_cluster(n_nodes, 1, 1)
    return infos


def test_resident_tick_places_past_the_old_guard(cuda):
    enc = torch_encode.IncrementalEncoder()
    p = enc.encode(_infos(65_537), [service_group(16_384)])
    rp = torch_resident.ResidentPlacement(enc, device=cuda)
    got = rp.schedule(p)
    assert rp._state[0].shape[0] == 1 << 17
    assert int(got.sum()) == 16_384
    np.testing.assert_array_equal(got, torch_batch.cpu_schedule_encoded(p))


def test_one_shot_places_past_the_old_guard(cuda):
    p = torch_encode.encode(_infos(20_000), [service_group(131_072)])
    got = torch_batch.device_schedule_encoded(p, device=cuda)
    assert int(got.sum()) == 131_072
    np.testing.assert_array_equal(got, torch_batch.cpu_schedule_encoded(p))


@pytest.mark.parametrize("strategy,lmax", [(0, 0), (0, 3), (1, 3)])
def test_overflow_flag_kernels_match_plain(cuda, strategy, lmax):
    """16 nodes, every one eligible for both groups at capacity n_tasks:
    group 0's sum is 2^31 (flagged, nothing placed or folded), group 1's
    16 * 4 (placed). K2 (LMAX 0), K3 and K9 equal their plain versions in
    counts, flags and carry, and the entry raises."""
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
    args[11] = torch.tensor([1 << 27, 4], dtype=torch.int32)
    if lmax == 0:
        args[19] = args[19][:, :0].contiguous()
    a = to_kernel_tensors(args, cuda)
    mask = torch_placement.static_mask(*a[:4], a[5], a[6], a[7], a[4], a[20])
    tables = torch_placement.FillTables(mask, a[13], a[11], a[12], a[14],
                                        a[15], a[16], a[17], a[19])
    if strategy == 1:
        step = torch_placement.binpack_fill_step
    else:
        step = (torch_placement.tree_fill_step if lmax
                else torch_placement.flat_fill_step)
    plain = getattr(torch_placement, step.__name__ + "_plain")
    runs = []
    for fn in (step, plain):
        st = torch_placement.FillState(a[9].clone(), a[10].clone(),
                                       a[8].clone(), a[18].clone())
        out = torch.full((2, 16), 7, dtype=torch.int32, device=cuda)
        flags = torch.full((2,), 5, dtype=torch.int32, device=cuda)
        for g in range(2):
            fn(tables, st, g, out, flags)
        runs.append((out, flags, *st))
    torch.cuda.synchronize()
    assert runs[0][1].tolist() == [1, 0]
    assert int(runs[0][0][0].abs().sum()) == 0
    assert int(runs[0][0][1].sum()) == 4
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="2\\^31"):
        torch_placement.schedule_groups(*a, strategy=strategy, device=cuda)
