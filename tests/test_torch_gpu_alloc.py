"""K19 `grant_order` against its plain PyTorch version on the card, at test
sizes and at the allocator phase's shapes (a /16 pool probed from 2 to
65,534 at the occupancy of a startup pass's first, middle and last chunk; a
2^20-slot pool at 50% occupancy), and the allocator on a /16 network on the
card against the same allocator with device="cpu". Every test here is
marked `gpu` and skips without a CUDA device; the file imports neither JAX
nor the JAX package, so on a machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_alloc.py

Outputs are int32 positions: the tolerance is exact equality.
"""
import numpy as np
import pytest
import torch

from swarmkit_tpu_torch.allocator.allocator import Allocator
from swarmkit_tpu_torch.api.objects import Network, Service, Task
from swarmkit_tpu_torch.api.specs import (
    Annotations,
    NetworkAttachmentConfig,
    NetworkSpec,
    ServiceSpec,
)
from swarmkit_tpu_torch.api.types import TaskState
from swarmkit_tpu_torch.ops import alloc as alloc_ops
from swarmkit_tpu_torch.store.memory import MemoryStore

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu

POOL_16 = 1 << 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _check(cuda, taken, cursor, lo, hi):
    t = torch.from_numpy(taken)
    before = alloc_ops.grant_order_launch.launches
    got = alloc_ops.grant_order_tensor(t.to(cuda), cursor, lo, hi)
    assert alloc_ops.grant_order_launch.launches == before + 1
    want = alloc_ops.grant_order_plain(t, cursor, lo, hi)
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    np.testing.assert_array_equal(
        got.cpu().numpy(), alloc_ops.grant_order_np(taken, cursor, lo, hi))
    return got


@pytest.mark.parametrize("seed", range(6))
def test_k19_fuzz(cuda, seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        size = int(rng.integers(8, 20_000))
        taken = rng.random(size) < rng.random()
        lo = int(rng.integers(0, size // 2))
        hi = int(rng.integers(lo, size - 1))
        _check(cuda, taken, int(rng.integers(0, size + 4)), lo, hi)


@pytest.mark.parametrize("case", ["span 1", "nothing free", "cursor past",
                                  "cursor below", "one tile edge"])
def test_k19_edges(cuda, case):
    if case == "span 1":
        for taken in ([0, 1, 0, 0], [0, 1, 1, 0]):
            _check(cuda, np.array(taken, bool), 2, 2, 2)
    elif case == "nothing free":
        got = _check(cuda, np.ones(10_000, bool), 77, 2, 9_998)
        assert got.numel() == 0
    elif case == "cursor past":
        _check(cuda, np.zeros(9_000, bool), 9_000, 2, 8_998)
    elif case == "cursor below":
        _check(cuda, np.zeros(9_000, bool), 3, 100, 8_000)
    else:
        taken = np.zeros(4096 * 3 + 3, bool)
        taken[::3] = True
        for cursor in (4095, 4096, 4097, 8192, taken.size - 2):
            _check(cuda, taken, cursor, 0, taken.size - 1)


@pytest.mark.parametrize("granted", [0, 25_000, 49_800])
def test_k19_on_a_startup_chunk(cuda, granted):
    """The /16 pool of the allocator phase after `granted` grants (the
    gateway, the VIP and that many tasks), probed from the cursor."""
    taken = np.zeros(POOL_16, bool)
    taken[1:3 + granted] = True
    got = _check(cuda, taken, 3 + granted, 2, POOL_16 - 2)
    assert int(got[0]) == 3 + granted


@pytest.mark.parametrize("cursor", [1 << 19, (1 << 20) + 5])
def test_k19_on_a_12_pool(cuda, cursor):
    rng = np.random.default_rng(cursor)
    taken = rng.random(1 << 20) < 0.5
    _check(cuda, taken, cursor, 2, (1 << 20) - 2)


def _store(n_tasks):
    store = MemoryStore()

    def seed(tx):
        tx.create(Network(id="net1", spec=NetworkSpec(
            annotations=Annotations(name="overlay"),
            ipam={"subnet": "10.0.0.0/16"})))
        s = Service(id="svc1", spec=ServiceSpec(
            annotations=Annotations(name="svc1")))
        s.spec.task.networks = [NetworkAttachmentConfig(target="net1")]
        tx.create(s)
        for i in range(n_tasks):
            t = Task(id=f"t{i:05d}", service_id="svc1")
            t.status.state = TaskState.NEW
            t.desired_state = TaskState.RUNNING
            tx.create(t)
    store.update(seed)
    return store


def test_allocator_on_the_card_equals_the_plain_version(cuda):
    out = []
    for device in (None, "cpu"):
        store = _store(450)
        a = Allocator(store, device=device)
        before = alloc_ops.grant_order_launch.launches
        a.on_start(store.view(a.setup))
        launched = alloc_ops.grant_order_launch.launches - before
        pool = a.ipam._pools["net1"]
        out.append(({t.id: (int(t.status.state), t.networks[0]["addresses"])
                     for t in store.view().find_tasks()},
                    pool.allocated, pool._cursor, launched))
    assert out[0][:3] == out[1][:3]
    assert out[0][3] == 3 and out[1][3] == 0    # chunks of 200: 200, 200, 50
    assert all(s == int(TaskState.PENDING) for s, _ in out[0][0].values())
