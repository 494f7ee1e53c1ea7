"""The port stands alone: no module of `swarmkit_tpu_torch` (nor the chip
smoke script) imports JAX or the JAX package, and its entry points run on
the card or raise -- they never fall back to the CPU on their own. Its
placement refuses only what the reference would sum wrongly in int32."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from swarmkit_tpu.ops import placement as jax_placement
from swarmkit_tpu_torch import entry as torch_entry
from swarmkit_tpu_torch.models import cluster_step as torch_cluster_step
from swarmkit_tpu_torch.ops import placement as torch_placement
from swarmkit_tpu_torch.ops import raft_replay as torch_replay
from swarmkit_tpu_torch.ops import reconcile as torch_reconcile
from swarmkit_tpu_torch.scheduler import batch as torch_batch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "swarmkit_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    files = sorted((ROOT / "swarmkit_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and getattr(node.func, "attr",
                            getattr(node.func, "id", "")) in (
                                "import_module", "__import__"):
            names = [node.args[0].value]
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "swarmkit_tpu_torch." + str(p.relative_to(ROOT / "swarmkit_tpu_torch")
                                    .with_suffix("")).replace(os.sep, ".")
        for p in (ROOT / "swarmkit_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print('BAD', bad) if bad else print('CLEAN')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "CLEAN", res.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, monkeypatch):
    args = torch_cluster_step.example_inputs(n_nodes=16, n_groups=2,
                                             tasks_per_group=4,
                                             device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_placement.schedule_groups(*args[2:])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_placement.schedule_groups_compact(*args[2:])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cluster_step.cluster_step(*args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cluster_step.example_inputs(n_nodes=16, n_groups=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_entry.entry()
    infos, groups = torch_cluster_step.example_cluster(16, 2, 4)
    from swarmkit_tpu_torch.scheduler.encode import encode
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_batch.device_schedule_encoded(encode(infos, groups))
    # the global reconcile at DIFF_THRESHOLD cells: the diff's kernel
    # branch, directly and through the orchestrator's bulk pass
    eligible = np.zeros((1, torch_reconcile.DIFF_THRESHOLD), bool)
    tn = np.full((1, 1), -1, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_reconcile.compute_diff(eligible, tn)
    from swarmkit_tpu_torch.api.objects import Node, Service
    from swarmkit_tpu_torch.api.specs import ServiceSpec
    from swarmkit_tpu_torch.api.types import NodeStatusState, ServiceMode
    from swarmkit_tpu_torch.orchestrator.global_ import GlobalOrchestrator
    from swarmkit_tpu_torch.store.memory import MemoryStore

    # a few cells reach the kernel branch once the threshold is lowered
    monkeypatch.setattr(torch_reconcile, "DIFF_THRESHOLD", 1)
    store = MemoryStore()

    def cluster(tx):
        for i in range(2):
            tx.create(Service(id=f"g{i}", spec=ServiceSpec(
                mode=ServiceMode.GLOBAL)))
        for i in range(3):
            n = Node(id=f"n{i}")
            n.status.state = NodeStatusState.READY
            tx.create(n)

    store.update(cluster)
    orch = GlobalOrchestrator(store)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            orch.bulk_reconcile([s.id for s in store.view().find_services()])
    finally:
        orch.stop()
    assert not store.view().find_tasks()


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; tensors on a
    device without a kernel raise instead of computing elsewhere."""
    acks = torch.zeros((3, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="meta"):
        torch_replay.replay_commit(acks, 2)
    elig = torch.zeros((2, 4), dtype=torch.bool, device="meta")
    tn = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    cnt = torch.zeros(8, dtype=torch.int32, device="meta")
    one = np.zeros(1, np.int32)
    for call in (
            lambda: torch_reconcile.global_diff(elig, tn),
            lambda: torch_reconcile.global_diff_update(elig, tn, one, one,
                                                       one),
            lambda: torch_reconcile.global_diff_update_compact(
                elig, tn, one, one, one, 4),
            lambda: torch_reconcile.diff_compact(elig, 4),
            lambda: torch_reconcile.task_count_flat(tn, 4),
            lambda: torch_reconcile.global_diff_churn(elig, tn, cnt, one,
                                                      one, one),
            lambda: torch_reconcile.global_diff_churn_burst(
                elig, tn, cnt, one[None], one[None], one[None])):
        with pytest.raises(ValueError, match="meta"):
            call()
    args = torch_cluster_step.example_inputs(n_nodes=16, n_groups=2,
                                             tasks_per_group=4,
                                             device="cpu")
    a = dict(zip(("ready", "node_val", "node_plat", "node_plugins",
                  "extra_mask", "constraints", "plat_req", "req_plugins"),
                 args[2:10]))
    meta = {k: v.to("meta") for k, v in a.items()}
    vol = torch.full((2, 0, 9), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="meta"):
        torch_placement.static_mask(
            meta["ready"], meta["node_val"], meta["node_plat"],
            meta["node_plugins"], meta["constraints"], meta["plat_req"],
            meta["req_plugins"], meta["extra_mask"], vol.to("meta"))
    mixed = dict(a, ready=meta["ready"])
    with pytest.raises(ValueError):
        torch_placement.static_mask(
            mixed["ready"], a["node_val"], a["node_plat"], a["node_plugins"],
            a["constraints"], a["plat_req"], a["req_plugins"],
            a["extra_mask"], vol)


def _open_cluster(args):
    """Every one of the 16 nodes eligible for both groups at capacity
    min(UNLIMITED, n_tasks): no constraints, platforms, plugins, resource
    needs, replica caps or ports."""
    args = [a.clone() for a in args]
    args[0].fill_(True)                  # ready
    args[4].fill_(True)                  # extra_mask
    args[5].fill_(-1)                    # constraints: all padded
    args[6].fill_(-2)                    # plat_req: none
    args[7].zero_()                      # req_plugins
    args[13].zero_()                     # need_res
    args[14].zero_()                     # max_replicas: unlimited
    args[16].zero_()                     # has_ports
    return args


@pytest.mark.parametrize("strategy", [0, 1])
@pytest.mark.parametrize("case", ["placed", "sum_below_2_31", "refused"])
def test_oversized_problem_is_refused(case, strategy):
    """The int32 contract: a group is refused only when its capacity sum,
    the sum over its eligible nodes of min(cap, n_tasks), reaches 2^31.

    `placed`: 16 nodes and 2 groups with n_tasks = 2^27 (N * max(n_tasks) =
    2^31, which the port used to refuse). Group 0 needs no resource but is
    constrained to fewer than 16 nodes, group 1's need caps it at a few
    tasks a node, so both sums stay below 2^31: placed, equal to the JAX
    package. `sum_below_2_31`: every node eligible and uncapped with
    n_tasks = 2^27 - 1, a sum of 2^31 - 16: placed, equal to JAX.
    `refused`: the same with n_tasks = 2^27, a sum of exactly 2^31. There
    the reference's int32 sum of capacities wraps to -2^31, so its quota
    min(n_tasks, sum) and every sum after it are wrong (it places more or
    fewer tasks than n_tasks): the port raises instead."""
    args = list(torch_cluster_step.example_inputs(
        n_nodes=16, n_groups=2, tasks_per_group=4, device="cpu")[2:])
    n_tasks = 1 << 27
    if case != "placed":
        args = _open_cluster(args)
    if case == "sum_below_2_31":
        n_tasks -= 1
    args[11] = torch.full((2,), n_tasks, dtype=torch.int32)
    want = jax_placement.schedule_groups(*(a.numpy() for a in args),
                                         strategy=strategy)
    if case == "refused":
        assert int(np.asarray(want[0]).sum(axis=1)[0]) != n_tasks
        with pytest.raises(ValueError, match="2\\^31"):
            torch_placement.schedule_groups(*args, strategy=strategy,
                                            device="cpu")
        return
    got = torch_placement.schedule_groups(*args, strategy=strategy,
                                          device="cpu")
    for g, w in zip(got, want):       # counts, totals, svc counts
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0][0].sum()) == n_tasks
