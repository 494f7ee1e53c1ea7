"""The flagship assembled step: placement plus raft replay.

The port of the JAX package's `models/cluster_step.py`. One cluster step
places every pending task group (`ops.placement.schedule_groups`, kernels
K1-K3, or K1 and K9 under binpack) and advances the raft commit frontier (`ops.raft_replay.
replay_commit`, kernel K4), on the card unless the caller passes
`device="cpu"`.

`example_inputs()` builds a self-contained synthetic cluster from a seed, as
the JAX package's does, so both packages can be driven with the same
arrays. The mesh generator `synth_shard_cluster` waits for the multi-GPU
slice.
"""
from __future__ import annotations

import random

import numpy as np

from ..convert import acks_from_numpy, as_tensor, kernel_args_from_arrays
from ..device import resolve_device


def cluster_step(acks, quorum, *placement_args, strategy: int = 0,
                 device=None):
    """One cluster step: place all pending groups, advance the commit
    frontier. Returns (counts int32[G, N], totals int32[N], commit_index
    int32 scalar); placement inputs follow `scheduler.encode.
    KERNEL_ARG_FIELDS`. strategy 0 = spread/topology, 1 = binpack."""
    from ..ops.placement import schedule_groups
    from ..ops.raft_replay import replay_commit

    dev = resolve_device(device)
    counts, totals, _svc_counts = schedule_groups(
        *placement_args, strategy=strategy, device=dev)
    acks = as_tensor(acks).to(dev)
    commit_index, _committed = replay_commit(acks, as_tensor(quorum).to(dev))
    return counts, totals, commit_index


def example_cluster(n_nodes: int = 256, n_groups: int = 4,
                    tasks_per_group: int = 64, seed: int = 0):
    """A synthetic (node_infos, task_groups) pair: labeled, resourced READY
    nodes and constrained task groups — the shapes the encoder feeds the
    flagship step."""
    from ..api.objects import Node, Task
    from ..api.specs import (
        Annotations,
        NodeDescription,
        Placement,
        Platform,
        Resources,
    )
    from ..api.types import NodeAvailability, NodeStatusState, TaskState
    from ..scheduler.encode import CPU_QUANTUM, MEM_QUANTUM, TaskGroup
    from ..scheduler.nodeinfo import NodeInfo

    rng = random.Random(seed)
    infos = []
    for i in range(n_nodes):
        n = Node(id=f"node-{i:05d}")
        n.status.state = NodeStatusState.READY
        n.status.addr = f"10.1.{i % 250}.{(i * 7) % 250}"
        n.spec.availability = NodeAvailability.ACTIVE
        n.spec.annotations = Annotations(
            name=f"node-{i}",
            labels={"zone": "abc"[i % 3], "disk": ("ssd", "hdd")[i % 2],
                    "rack": f"r{i % 17}"})
        n.description = NodeDescription(
            hostname=f"host-{i}",
            platform=Platform(os="linux", architecture="amd64"),
            resources=Resources(
                nano_cpus=rng.randint(4, 16) * CPU_QUANTUM * 1000,
                memory_bytes=rng.randint(8, 64) * MEM_QUANTUM * 1024,
                # discrete generic pool on a quarter of the fleet so the
                # generic-resource columns are part of the flagship surface
                generic={"gpu": 2} if i % 4 == 0 else {},
            ),
        )
        infos.append(NodeInfo.new(n, {}, n.description.resources.copy()))

    groups = []
    for gi in range(n_groups):
        svc = f"svc-{gi:03d}"
        tasks = []
        spec = None
        for ti in range(tasks_per_group):
            t = Task(id=f"task-{gi:03d}-{ti:05d}", service_id=svc,
                     slot=ti + 1)
            t.desired_state = TaskState.RUNNING
            t.status.state = TaskState.PENDING
            if spec is None:
                from ..api.specs import PlacementPreference

                spec = t.spec
                spec.resources.reservations.nano_cpus = \
                    (gi % 3) * CPU_QUANTUM
                spec.resources.reservations.memory_bytes = \
                    (gi % 4) * MEM_QUANTUM
                if gi % 2 == 0:
                    spec.placement = Placement(
                        constraints=[f"node.labels.zone == {'abc'[gi % 3]}"])
                if gi % 3 == 1:
                    # spread-tree groups (LMAX>0): one-, two- and
                    # THREE-level preference trees so the segmented pour
                    # path is part of the flagship compile surface at the
                    # depth real topologies use (zone > disk > rack)
                    prefs = [PlacementPreference(
                        spread_descriptor="node.labels.zone")]
                    if gi % 2 == 1:
                        prefs.append(PlacementPreference(
                            spread_descriptor="node.labels.disk"))
                    if gi % 6 == 1:
                        prefs.append(PlacementPreference(
                            spread_descriptor="node.labels.rack"))
                    spec.placement.preferences = prefs
                if gi % 7 == 3:
                    # generic-resource consumers (gpu pool nodes only)
                    spec.resources.reservations.generic = {"gpu": 1}
            else:
                t.spec = spec
            if gi % 5 == 2:
                # host-published ports: within-tick port conflicts between
                # groups publishing the same port ride the kernel's
                # port_used ORs
                from ..api.specs import EndpointSpec, PortConfig

                t.endpoint = EndpointSpec(ports=[PortConfig(
                    protocol="tcp", target_port=80,
                    published_port=8000 + (gi % 10),
                    publish_mode="host")])
            tasks.append(t)
        groups.append(TaskGroup(service_id=svc, spec_version=1, tasks=tasks,
                                ids=[t.id for t in tasks]))
    return infos, groups


def example_inputs(n_nodes: int = 256, n_groups: int = 4,
                   tasks_per_group: int = 64, n_managers: int = 5,
                   log_len: int = 1024, seed: int = 0, device=None):
    """(acks, quorum, *placement_args) ready for `cluster_step`, as tensors
    on `device` (the card unless `device="cpu"`). The arrays equal the JAX
    package's `example_inputs` for the same arguments."""
    from ..scheduler.encode import encode, kernel_args

    dev = resolve_device(device)
    infos, groups = example_cluster(n_nodes, n_groups, tasks_per_group, seed)
    placement_args = kernel_args_from_arrays(kernel_args(encode(infos, groups)),
                                             dev)
    rng = np.random.RandomState(seed)
    acks, quorum = acks_from_numpy(rng.rand(n_managers, log_len) < 0.8,
                                   np.int32(n_managers // 2 + 1), dev)
    return (acks, quorum) + placement_args
