"""The port's grant order and array pools against the JAX package.

`swarmkit_tpu_torch.ops.alloc` (`grant_order` on both branches with
device="cpu", `grant_order_plain`, `grant_order_np`) is held against the
JAX `grant_order(..., use_jax=True)` and `grant_order_np` on the JAX
test's own generator and on the edges (a one-slot span, no free slot,
cursors outside the range, a /16 pool); the port's `BatchedIPAM` and
`BatchedPorts` against the JAX pools and the scalar `IPAM` and
`PortAllocator` on the op sequences of the JAX fuzz, with a /19 pool so
that the device branch's plain version runs. Outputs are int32 positions
and address strings: the tolerance is exact equality, dtype included.

Without a CUDA device the device branch raises and never falls back to
the CPU on its own; a pool at or below POOL_THRESHOLD still grants, in
numpy, by the JAX package's rule.
"""
import copy
import ipaddress
import random

import numpy as np
import pytest
import torch

from swarmkit_tpu.allocator import allocator as jax_alloc_mod
from swarmkit_tpu.allocator import batched as jax_batched_mod
from swarmkit_tpu.allocator.batched import BatchedIPAM as JaxBatchedIPAM
from swarmkit_tpu.allocator.batched import BatchedPorts as JaxBatchedPorts
from swarmkit_tpu.allocator.ipam import IPAM as JaxIPAM
from swarmkit_tpu.ops import alloc as jax_alloc
from swarmkit_tpu_torch.allocator import allocator as alloc_mod
from swarmkit_tpu_torch.allocator import batched as batched_mod
from swarmkit_tpu_torch.allocator.allocator import (
    DYNAMIC_PORT_START,
    Allocator,
    PortAllocator,
)
from swarmkit_tpu_torch.allocator.batched import BatchedIPAM, BatchedPorts
from swarmkit_tpu_torch.allocator.ipam import IPAM, IPAMError
from swarmkit_tpu_torch.api.objects import Network, Service, Task
from swarmkit_tpu_torch.api.specs import (
    Annotations,
    NetworkAttachmentConfig,
    NetworkSpec,
    PortConfig,
    ServiceSpec,
)
from swarmkit_tpu_torch.api.types import TaskState
from swarmkit_tpu_torch.ops import alloc as alloc_ops
from swarmkit_tpu_torch.store.memory import MemoryStore

torch.set_num_threads(1)


def _all_forms(taken, cursor, lo, hi):
    """Every form of the grant order, the JAX package's first; the port's
    dispatch on both branches, the device one reached by moving the
    threshold below the pool."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(alloc_ops, "POOL_THRESHOLD", 0)
        kernel_branch = alloc_ops.grant_order(taken, cursor, lo, hi,
                                              device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(alloc_ops, "POOL_THRESHOLD", taken.shape[0])
        numpy_branch = alloc_ops.grant_order(taken, cursor, lo, hi)
    return {
        "jax np": jax_alloc.grant_order_np(taken, cursor, lo, hi),
        "jax kernel": jax_alloc.grant_order(taken, cursor, lo, hi,
                                            use_jax=True),
        "np": alloc_ops.grant_order_np(taken, cursor, lo, hi),
        "numpy branch": numpy_branch,
        "kernel branch": kernel_branch,
        "plain": alloc_ops.grant_order_plain(torch.from_numpy(taken), cursor,
                                             lo, hi).numpy(),
        "tensor": alloc_ops.grant_order_tensor(torch.from_numpy(taken),
                                               cursor, lo, hi).numpy(),
    }


def _assert_all_equal(taken, cursor, lo, hi):
    forms = _all_forms(taken, cursor, lo, hi)
    want = forms.pop("jax np")
    for name, got in forms.items():
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    return want


# ------------------------------------------------------------ grant order
@pytest.mark.parametrize("seed", range(6))
def test_grant_order_matches_jax(seed):
    """The JAX test's generator: sizes 8-600, cursors up to size + 4."""
    rng = np.random.default_rng(seed)
    for _ in range(10):
        size = int(rng.integers(8, 600))
        taken = rng.random(size) < rng.random()
        lo = int(rng.integers(0, size // 2))
        hi = int(rng.integers(lo, size - 1))
        cursor = int(rng.integers(0, size + 4))
        _assert_all_equal(taken, cursor, lo, hi)


EDGES = {
    # a /30 pool: gateway at 1, the one host at 2
    "span 1 free": (np.array([0, 1, 0, 0], bool), 2, 2, 2),
    "span 1 taken": (np.array([0, 1, 1, 0], bool), 2, 2, 2),
    "span 1 cursor past": (np.array([0, 1, 0, 0], bool), 3, 2, 2),
    "nothing free": (np.ones(40, bool), 17, 2, 38),
    "cursor below lo": (np.zeros(40, bool), 1, 5, 30),
    "cursor past hi": (np.zeros(40, bool), 31, 5, 30),
    "cursor far past": (np.zeros(40, bool), 44, 5, 30),
    "cursor at hi": (np.zeros(40, bool), 30, 5, 30),
    "only the slot before the cursor free": (
        np.r_[np.ones(20, bool), [False], np.ones(19, bool)], 21, 2, 38),
}


@pytest.mark.parametrize("case", list(EDGES))
def test_grant_order_edges(case):
    taken, cursor, lo, hi = EDGES[case]
    got = _assert_all_equal(taken, cursor, lo, hi)
    if case.startswith("nothing") or case == "span 1 taken":
        assert got.shape == (0,)


@pytest.mark.parametrize("cursor", [2, 30_000, 65_534, 65_535, 70_000])
def test_grant_order_on_a_16_pool(cursor):
    """One /16 pool as `_ArrayPool.allocate_many` probes it: lo = 2,
    hi = size - 2, so neither the gateway nor the broadcast appears."""
    rng = np.random.default_rng(cursor)
    size = 1 << 16
    taken = rng.random(size) < 0.5
    taken[1] = True
    got = _assert_all_equal(taken, cursor, 2, size - 2)
    assert got.size == int((~taken[2:size - 1]).sum())
    assert 1 not in got and size - 1 not in got and 0 not in got


def test_grant_order_refuses_what_int32_cannot_hold():
    with pytest.raises(ValueError, match="probe range"):
        alloc_ops.grant_order_plain(torch.zeros(8, dtype=torch.bool), 0, 5,
                                    8)
    with pytest.raises(ValueError, match="probe range"):
        alloc_ops.grant_order_plain(torch.zeros(8, dtype=torch.bool), 0, 5,
                                    4)


# ------------------------------------------------------- no CUDA, no quiet CPU
@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_branch_raises_without_cuda(no_cuda):
    taken = np.zeros(alloc_ops.POOL_THRESHOLD + 1, bool)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        alloc_ops.grant_order(taken, 2, 2, taken.shape[0] - 2)
    # at the threshold the numpy branch runs, by the JAX package's rule
    small = taken[:alloc_ops.POOL_THRESHOLD]
    np.testing.assert_array_equal(
        alloc_ops.grant_order(small, 2, 2, small.shape[0] - 2),
        jax_alloc.grant_order(small, 2, 2, small.shape[0] - 2))


def test_meta_tensor_raises_in_the_wrapper():
    with pytest.raises(ValueError, match="no grant order kernel"):
        alloc_ops.grant_order_tensor(
            torch.zeros(16, dtype=torch.bool, device="meta"), 2, 2, 14)


def _seed_cluster(store, n_tasks, subnet):
    def seed(tx):
        tx.create(Network(id="net1", spec=NetworkSpec(
            annotations=Annotations(name="backend"),
            ipam={"subnet": subnet})))
        s = Service(id="svc1", spec=ServiceSpec(
            annotations=Annotations(name="svc1"), replicas=n_tasks))
        s.spec.task.networks = [NetworkAttachmentConfig(target="net1")]
        tx.create(s)
        for i in range(n_tasks):
            t = Task(id=f"t{i:04d}", service_id="svc1", slot=i + 1)
            t.status.state = TaskState.NEW
            t.desired_state = TaskState.RUNNING
            tx.create(t)
    store.update(seed)


def test_allocator_on_a_16_raises_without_cuda(no_cuda):
    store = MemoryStore()
    _seed_cluster(store, 5, "10.70.0.0/16")
    a = Allocator(store)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        a.on_start(store.view(a.setup))
    # the chunk's grants went back: only the service VIP is held
    assert a.ipam._pools["net1"].allocated == {"10.70.0.1", "10.70.0.2"}
    assert all(t.status.state == TaskState.NEW
               for t in store.view().find_tasks())


def test_allocator_on_a_24_allocates_without_cuda(no_cuda):
    store = MemoryStore()
    _seed_cluster(store, 5, "10.71.0.0/24")
    a = Allocator(store)
    a.on_start(store.view(a.setup))
    tasks = store.view().find_tasks()
    assert all(t.status.state == TaskState.PENDING for t in tasks)
    assert [t.networks[0]["addresses"][0] for t in tasks] == [
        f"10.71.0.{i}" for i in range(3, 8)]


# ------------------------------------------------------------- IPAM fuzz
def _pool_state(ipam, net_id):
    pool = ipam._pools[net_id]
    return set(pool.allocated), pool._cursor


@pytest.mark.parametrize("seed", range(12))
def test_ipam_fuzz_matches_jax_and_scalar(seed):
    """The JAX fuzz's op sequence (allocate, allocate_many, release,
    reserve, exhaustion) over its three small pools plus a /19, on the
    port's array pools, the port's scalar IPAM, and the JAX array and
    scalar pools: every grant, cursor and allocated set equal."""
    rng = random.Random(seed)
    pools = {"oracle": IPAM(), "batched": BatchedIPAM(device="cpu"),
             "jax": JaxBatchedIPAM(), "jax oracle": JaxIPAM()}
    nets = []
    bits = rng.sample([28, 29, 27, 26], 3) + [19]
    for i, b in enumerate(bits):
        sub = f"10.{seed}.{32 * i}.0/{b}"
        got = {k: p.add_network(f"net{i}", sub) for k, p in pools.items()}
        assert len(set(got.values())) == 1
        nets.append((f"net{i}", ipaddress.ip_network(sub)))
    batched = [pools["batched"], pools["jax"]]
    scalar = [pools["oracle"], pools["jax oracle"]]
    live: list[tuple[str, str]] = []
    for _ in range(120):
        net_id, sub = rng.choice(nets)
        op = rng.random()
        if op < 0.45:
            try:
                a = scalar[0].allocate(net_id)
            except IPAMError:
                for p in scalar[1:] + batched:
                    with pytest.raises(Exception, match="exhausted"):
                        p.allocate(net_id)
            else:
                assert [p.allocate(net_id)
                        for p in scalar[1:] + batched] == [a] * 3
                live.append((net_id, a))
        elif op < 0.65:
            k = rng.randint(1, 6)
            free = batched[0].free_count(net_id)
            assert batched[1].free_count(net_id) == free
            if k <= free:
                grants = batched[0].allocate_many(net_id, k)
                assert batched[1].allocate_many(net_id, k) == grants
                for p in scalar:
                    assert [p.allocate(net_id) for _ in range(k)] == grants
                live.extend((net_id, a) for a in grants)
            else:
                before = _pool_state(batched[0], net_id)
                for p in batched:
                    with pytest.raises(Exception, match="exhausted"):
                        p.allocate_many(net_id, k)
                assert _pool_state(batched[0], net_id) == before
        elif op < 0.85 and live:
            nid, addr = live.pop(rng.randrange(len(live)))
            for p in pools.values():
                p.release(nid, addr)
        else:
            host = rng.randrange(2, sub.num_addresses - 1)
            addr = str(sub.network_address + host)
            for p in pools.values():
                p.reserve(net_id, addr)
        for nid, _ in nets:
            want = _pool_state(pools["jax oracle"], nid)
            for k, p in pools.items():
                assert _pool_state(p, nid) == want, \
                    f"seed {seed}: pool {nid} of {k} diverged"


def test_allocate_many_zero_is_a_noop():
    batched = BatchedIPAM(device="cpu")
    batched.add_network("n", "10.8.0.0/28")
    before = _pool_state(batched, "n")
    assert batched.allocate_many("n", 0) == []
    assert _pool_state(batched, "n") == before


@pytest.mark.parametrize("subnet,hosts", [("10.9.0.0/29", 5),
                                          ("10.9.0.0/30", 1)])
def test_ipam_exhaustion_then_release_matches_jax(subnet, hosts):
    pools = [IPAM(), BatchedIPAM(device="cpu"), JaxIPAM(), JaxBatchedIPAM()]
    for p in pools:
        p.add_network("n", subnet)
    got = []
    for _ in range(hosts):
        grants = {p.allocate("n") for p in pools}
        assert len(grants) == 1
        got.append(grants.pop())
    for p in pools:
        with pytest.raises(Exception, match="exhausted"):
            p.allocate("n")
        p.release("n", got[-1])
    assert {p.allocate("n") for p in pools} == {got[-1]}
    assert len({frozenset(_pool_state(p, "n")[0]) for p in pools}) == 1
    assert len({_pool_state(p, "n")[1] for p in pools}) == 1


def test_a_19_pool_grants_through_the_device_branch(monkeypatch):
    """allocate_many on a pool above POOL_THRESHOLD takes the device
    branch: with device="cpu" the plain version, equal to the JAX
    kernel's grants."""
    calls = []
    real = alloc_ops.grant_order_tensor

    def spy(*a):
        calls.append(a[1:])
        return real(*a)
    monkeypatch.setattr(alloc_ops, "grant_order_tensor", spy)
    port, jax_ = BatchedIPAM(device="cpu"), JaxBatchedIPAM()
    for p in (port, jax_):
        p.add_network("n", "10.20.0.0/19")
        p.reserve("n", "10.20.0.3")
    assert port.allocate_many("n", 300) == jax_.allocate_many("n", 300)
    assert calls == [(2, 2, 8190)]
    assert _pool_state(port, "n") == _pool_state(jax_, "n")


# ------------------------------------------------------------- ports fuzz
def _shrink_port_range(monkeypatch, span):
    """Shrink the dynamic range of both packages so a fuzz can exhaust
    it: the modules read the bounds from module globals at call time."""
    end = DYNAMIC_PORT_START + span - 1
    for mod in (alloc_mod, batched_mod, jax_alloc_mod, jax_batched_mod):
        monkeypatch.setattr(mod, "DYNAMIC_PORT_END", end)
    for mod in (batched_mod, jax_batched_mod):
        monkeypatch.setattr(mod, "_PORT_SPAN", span)


def _rand_ports(rng, span):
    ports = []
    for _ in range(rng.randint(1, 5)):
        kind = rng.random()
        if kind < 0.45:
            ports.append(PortConfig(protocol=rng.choice(["tcp", "udp"]),
                                    target_port=80))
        elif kind < 0.7:
            ports.append(PortConfig(
                protocol=rng.choice(["tcp", "udp"]), target_port=80,
                published_port=DYNAMIC_PORT_START + rng.randrange(span)))
        else:
            ports.append(PortConfig(
                protocol="tcp", target_port=80,
                published_port=rng.randint(8000, 9000)))
    return ports


@pytest.mark.parametrize("seed", range(10))
def test_ports_fuzz_matches_jax_and_scalar(seed, monkeypatch):
    """The JAX ports fuzz: grants (a failed run's partial grants
    included), verdicts, release_except and the cursor, on the port's
    BatchedPorts and PortAllocator and the JAX BatchedPorts."""
    span = 24
    _shrink_port_range(monkeypatch, span)
    rng = random.Random(100 + seed)
    allocs = [PortAllocator(), BatchedPorts(), JaxBatchedPorts()]
    services: list[str] = []
    for step in range(60):
        op = rng.random()
        if op < 0.6 or not services:
            sid = f"svc{step}"
            ports = _rand_ports(rng, span)
            copies = [copy.deepcopy(ports) for _ in allocs]
            verdicts = [a.allocate(sid, c) for a, c in zip(allocs, copies)]
            assert len(set(verdicts)) == 1, f"seed {seed} step {step}"
            assert len({tuple(p.published_port for p in c)
                        for c in copies}) == 1
            if verdicts[0]:
                services.append(sid)
        elif op < 0.8:
            sid = services.pop(rng.randrange(len(services)))
            for a in allocs:
                a.release(sid)
        else:
            sid = rng.choice(services)
            mine = sorted(k for k, v in allocs[0]._allocated.items()
                          if v == sid)
            keep = set(rng.sample(mine, k=rng.randint(0, len(mine))))
            assert len({a.release_except(sid, keep) for a in allocs}) == 1
        for a in allocs[1:]:
            assert a._allocated == allocs[0]._allocated, \
                f"seed {seed} step {step}"
            assert a._next_dynamic == allocs[0]._next_dynamic, \
                f"seed {seed} step {step}"
