"""K18 `replica_slot_state` against its plain PyTorch version on the card:
the census fuzz and edge inputs of `tests/test_torch_batched_orch.py`, a
census of 2^20 services x 16 slots and one at the replicated phase's
shape (100,000 services x 11 slots), the wrapper's refusals on CUDA
tensors, and the batched reconciler on the card against the same with
device="cpu". Every test here is marked `gpu` and skips without a CUDA
device; the file imports neither JAX nor the JAX package, so on a machine
without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_replicated.py

Outputs are bool planes and int32 counts: the tolerance is exact equality.
"""
import numpy as np
import pytest
import torch

from swarmkit_tpu_torch.api.objects import Service, Task, Version
from swarmkit_tpu_torch.api.specs import Annotations, ServiceSpec
from swarmkit_tpu_torch.api.types import TaskState
from swarmkit_tpu_torch.orchestrator.batched import BatchedReconciler
from swarmkit_tpu_torch.ops import reconcile as rc
from swarmkit_tpu_torch.store.memory import MemoryStore

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _inputs(rng, S, M, T, p_run=0.6):
    sidx = rng.integers(0, S, T).astype(np.int32)
    slot = rng.integers(0, M, T).astype(np.int32)
    runnable = rng.random(T) < p_run
    running = runnable & (rng.random(T) < 0.6)
    return sidx, slot, runnable, running


def _check(cuda, sidx, slot, runnable, running, S, M):
    host = [torch.from_numpy(x) for x in (sidx, slot, runnable, running)]
    before = rc.replica_slot_state.launches
    got = rc.replica_slot_state(*(t.to(cuda) for t in host), S, M)
    torch.cuda.synchronize()
    assert rc.replica_slot_state.launches == before + 1
    want = rc.replica_slot_state_plain(*host, S, M)
    mirror = rc.replica_slot_state_np(sidx, slot, runnable, running, S, M)
    for g, w, m in zip(got, want, mirror):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)
        np.testing.assert_array_equal(g.cpu().numpy(), m)
    return got


@pytest.mark.parametrize("seed", range(20))
def test_k18_fuzz(cuda, seed):
    rng = np.random.default_rng(seed)
    S, M = int(rng.integers(1, 8)), int(rng.integers(1, 10))
    _check(cuda, *_inputs(rng, S, M, int(rng.integers(1, 60))), S, M)


@pytest.mark.parametrize("seed", range(4))
def test_k18_wide_rows(cuda, seed):
    """Rows wider than a warp (the strided lane sum) and many tasks a
    slot (the racing byte stores)."""
    rng = np.random.default_rng(100 + seed)
    S, M = int(rng.integers(1, 300)), int(rng.integers(33, 4097))
    _check(cuda, *_inputs(rng, S, M, int(rng.integers(1, 50_000))), S, M)


EDGES = {
    "one cell": (1, 1, lambda r: _inputs(r, 1, 1, 5)),
    "no tasks": (3, 4, lambda r: (np.zeros(0, np.int32),
                                  np.zeros(0, np.int32),
                                  np.zeros(0, bool), np.zeros(0, bool))),
    "all on the last key": (5, 7, lambda r: (
        np.full(9, 4, np.int32), np.full(9, 6, np.int32),
        r.random(9) < 0.5, np.zeros(9, bool))),
    "all runnable": (6, 5, lambda r: _inputs(r, 6, 5, 40, 1.0)),
    "none runnable": (6, 5, lambda r: _inputs(r, 6, 5, 40, 0.0)),
    "no slots": (4, 0, lambda r: (np.zeros(0, np.int32),
                                  np.zeros(0, np.int32),
                                  np.zeros(0, bool), np.zeros(0, bool))),
}


@pytest.mark.parametrize("edge", list(EDGES))
def test_k18_edges(cuda, edge):
    S, M, make = EDGES[edge]
    _check(cuda, *make(np.random.default_rng(5)), S, M)


def test_k18_million_cells(cuda):
    """2^20 services x 16 slots (16.8 M cells), 3 M tasks; and the
    replicated phase's census shape, 100,000 x 11, through
    compute_slot_state from host arrays, against the numpy mirror."""
    rng = np.random.default_rng(9)
    S, M = 1 << 20, 16
    _check(cuda, *_inputs(rng, S, M, 3_000_000), S, M)
    S, M = 100_000, 11
    args = _inputs(rng, S, M, 208_000)
    before = rc.replica_slot_state.launches
    got = rc.compute_slot_state(*args, S, M)
    assert rc.replica_slot_state.launches == before + 1
    for g, w in zip(got, rc.replica_slot_state_np(*args, S, M)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_k18_refusals_on_the_card(cuda):
    rng = np.random.default_rng(1)
    sidx, slot, runnable, running = (torch.from_numpy(x).to(cuda) for x in
                                     _inputs(rng, 4, 5, 30))
    before = rc.replica_slot_state.launches
    for s, m in ((sidx + 4, slot), (sidx - 5, slot), (sidx, slot + 5),
                 (sidx, slot - 5)):
        with pytest.raises(ValueError, match="outside"):
            rc.replica_slot_state(s, m, runnable, running, 4, 5)
    for args in ((sidx.long(), slot, runnable, running),
                 (sidx, slot, runnable.int(), running),
                 (sidx[None], slot, runnable, running)):
        with pytest.raises(ValueError, match="expected a 1-D"):
            rc.replica_slot_state(*args, 4, 5)
    with pytest.raises(ValueError, match="2\\^31"):
        rc.replica_slot_state(sidx, slot, runnable, running, 1 << 16,
                              1 << 15)
    with pytest.raises(ValueError):
        rc.replica_slot_state(sidx.cpu(), slot, runnable, running, 4, 5)
    assert rc.replica_slot_state.launches == before


def test_reconciler_on_the_card_equals_cpu(cuda, monkeypatch):
    """decide_many with the census on the card (the threshold lowered to
    its cell count) equals device="cpu", service for service."""
    store = MemoryStore()
    rng = np.random.default_rng(2)

    def cb(tx):
        for s in range(300):
            svc = Service(id=f"s{s:03d}", spec=ServiceSpec(
                annotations=Annotations(name=f"s{s:03d}"),
                replicas=int(rng.integers(0, 6))))
            svc.spec_version = Version(1)
            tx.create(svc)
            for slot in range(1, int(rng.integers(0, 8)) + 1):
                t = Task(id=f"t{s:03d}-{slot}", service_id=svc.id, slot=slot)
                t.spec = svc.spec.task
                t.spec_version = Version(1)
                t.desired_state = TaskState.RUNNING
                t.status.state = TaskState(int(rng.choice(
                    [int(TaskState.RUNNING), int(TaskState.FAILED),
                     int(TaskState.PENDING)])))
                t.node_id = f"n{int(rng.integers(4))}"
                tx.create(t)

    store.update(cb)
    monkeypatch.setattr(rc, "DIFF_THRESHOLD", 1)
    ids = [f"s{s:03d}" for s in range(300)]

    def norm(ds):
        return {k: (d.create_slots, d.victim_slots,
                    [[t.id for t in ts] for ts in d.dirty_slots],
                    d.kick_update) for k, d in ds.items()}

    before = rc.replica_slot_state.launches
    got = norm(BatchedReconciler(store).decide_many(ids))
    assert rc.replica_slot_state.launches == before + 1
    assert got == norm(BatchedReconciler(store, device="cpu")
                       .decide_many(ids))
    assert got
