"""The flagship assembled step: placement plus raft replay.

The port of the JAX package's `models/cluster_step.py`. One cluster step
places every pending task group (`ops.placement.schedule_groups`, kernels
K1-K3, or K1 and K9 under binpack) and advances the raft commit frontier (`ops.raft_replay.
replay_commit`, kernel K4), on the card unless the caller passes
`device="cpu"`.

`example_inputs()` builds a self-contained synthetic cluster from a seed, as
the JAX package's does, so both packages can be driven with the same
arrays. `synth_shard_cluster` builds the mesh's scale-out problem
array-native, equal to the JAX package's field for field.
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


def synth_shard_cluster(n_nodes: int, n_shards: int,
                        groups_per_shard: int = 4,
                        tasks_per_group: int = 31_250,
                        seed: int = 0, lmax: int = 2,
                        with_ports: bool = True,
                        with_voltopo: bool = True,
                        strategy: str = "spread"):
    """Array-native synthetic cluster at oracle-infeasible scale.

    Builds an EncodedProblem DIRECTLY as numpy arrays — no Node/Task/
    NodeInfo objects, no encoder pass — so the 100k–1M-node grid costs
    O(N) vectorized numpy instead of a million Python objects (the
    memory-bounded construction the mesh flagship needs; the 10k-node
    `example_cluster` path stays the object-built, encoder-validated
    shape).

    The problem is built SHARD-PARTITIONED for the sampled-shard parity
    methodology (`parallel/shard_parity.py`): nodes split into `n_shards` contiguous
    slices, every group is eligible on exactly one slice via an interned
    constraint, the spread label tree nests within slices (level-0 branch
    ids encode the shard), warm service counts stay within the owning
    slice, and port ids are reused only within a slice. Under those
    rules the global sequential-group fill RESTRICTED to one slice is
    bit-identical to the greedy CPU oracle run on that slice alone —
    which is what `parallel.shard_parity.sampled_shard_parity` checks at
    sizes where the full Python oracle cannot run.

    with_voltopo adds the CSI volume-topology mask leg: a
    second node_val column carries a shard-prefixed "csi zone" id and
    every 4th group requires mount 0 to match one of two zone values of
    ITS OWN shard. The leg is node-local (a pure static-mask AND), so
    slicing is trivially sound — but shard-prefixed values keep the
    synthetic honest: a group's rows can never match outside its slice.

    strategy stamps the problem's scoring engine ("spread" | "binpack" |
    "topology" — topology is spread with the axis already folded into
    the level-0 ranks here, so it shares the spread code path).

    Returns (EncodedProblem, group_shard int32[G]). The arrays equal the
    JAX package's for the same arguments.
    """
    from ..scheduler.encode import (
        OP_EQ,
        VOL_TOPO_SEGS,
        EncodedProblem,
        _empty_vol_topo,
    )

    assert n_nodes % n_shards == 0, "shards are contiguous equal slices"
    per = n_nodes // n_shards
    N = n_nodes
    G = n_shards * groups_per_shard
    rng = np.random.RandomState(seed)
    shard_of_node = np.repeat(np.arange(n_shards, dtype=np.int32), per)
    # groups interleave shards so the kernel's sequential fold alternates
    # slices (the realistic store order, and the harder parity case)
    group_shard = (np.arange(G, dtype=np.int32) % n_shards)

    p = EncodedProblem(
        node_ids=[f"n{i:07d}" for i in range(N)],
        group_keys=[(f"svc-{gi:04d}", 1) for gi in range(G)],
        service_ids=[f"svc-{gi:04d}" for gi in range(G)],
        groups=[],
    )
    p.ready = rng.rand(N) > 0.01
    p.strategy = strategy
    if with_voltopo:
        # csi zone column (node_val col 1): shard-prefixed ids so a
        # group's vol-topo rows can only ever match inside its slice
        ZV = 3
        zone = (shard_of_node * ZV
                + rng.randint(0, ZV, N) + 1).astype(np.int32)
        p.node_val = np.stack(
            [(shard_of_node + 1).astype(np.int32), zone], axis=1)
    else:
        p.node_val = (shard_of_node + 1).reshape(N, 1).astype(np.int32)
    p.node_plat = np.zeros((N, 2), np.int32)
    p.node_plugins = np.zeros((N, 1), bool)
    PV = 4
    p.port_used0 = np.zeros((N, PV), bool)
    if with_ports:
        # a sprinkle of pre-used host ports (column 1) so the conflict
        # mask is live from tick 0
        p.port_used0[rng.rand(N) < 0.002, 1] = True
    p.avail_res = np.stack(
        [rng.randint(20, 400, N), rng.randint(50, 1000, N)],
        axis=1).astype(np.int32)
    p.total0 = rng.randint(0, 5, N).astype(np.int32)
    # warm per-service counts, CONFINED to the owning shard's slice
    p.svc_count0 = np.zeros((G, N), np.int32)
    for gi in range(0, G, 2):
        s = int(group_shard[gi])
        a, b = s * per, (s + 1) * per
        hot = rng.rand(per) < 0.05
        p.svc_count0[gi, a:b][hot] = rng.randint(
            1, 4, int(hot.sum())).astype(np.int32)

    p.n_tasks = np.full(G, tasks_per_group, np.int32)
    p.svc_idx = np.arange(G, dtype=np.int32)
    p.svc_idx_persistent = np.arange(G, dtype=np.int32)
    p.n_svc_rows = G
    p.need_res = np.stack(
        [rng.randint(0, 4, G), rng.randint(0, 5, G)],
        axis=1).astype(np.int32)
    p.max_replicas = np.where(np.arange(G) % 5 == 0, 3, 0).astype(np.int32)
    p.constraints = np.full((G, 1, 3), -1, np.int32)
    p.constraints[:, 0, 0] = 0                       # key col: shard label
    p.constraints[:, 0, 1] = OP_EQ
    p.constraints[:, 0, 2] = group_shard + 1         # interned shard value
    p.plat_req = np.full((G, 1, 2), -2, np.int32)
    p.req_plugins = np.zeros((G, 1), bool)
    p.has_ports = np.zeros(G, bool)
    p.group_ports = np.zeros((G, PV), bool)
    if with_ports:
        # every 6th group publishes a host port; groups of the SAME shard
        # reuse columns, so within-tick conflicts are exercised without
        # cross-shard coupling
        for gi in range(5, G, 6):
            p.has_ports[gi] = True
            p.group_ports[gi, (gi // n_shards) % 2] = True
    p.penalty = np.zeros((G, N), bool)
    p.penalty_nonzero = False
    p.extra_mask = np.ones((G, N), bool)
    p.extra_mask_all = True
    if with_voltopo:
        # every 4th group: mount 0 accepts either of two zone values of
        # the group's OWN shard (two alternative rows — the ∃-candidate
        # OR the kernel leg evaluates)
        ZV = 3
        W = 1 + 2 * VOL_TOPO_SEGS
        p.vol_topo = np.full((G, 2, W), -1, np.int32)
        for gi in range(3, G, 4):
            s = int(group_shard[gi])
            p.vol_topo[gi, 0, :3] = (0, 1, s * ZV + 1 + (gi % ZV))
            p.vol_topo[gi, 1, :3] = (0, 1, s * ZV + 1 + ((gi + 1) % ZV))
        p.vol_topo_any = True
    else:
        p.vol_topo = _empty_vol_topo(G)
        p.vol_topo_any = False
    # spread tree nested within shards: level-0 branch id encodes the
    # shard (branches never span a slice); level l+1 refines level l with
    # a contiguous child-id range per parent — the encoder's prefix-rank
    # invariant, constructed directly
    if lmax:
        Z, W = 4, 4
        r0 = shard_of_node * Z + rng.randint(0, Z, N).astype(np.int32)
        levels = [r0]
        for _ in range(1, lmax):
            levels.append(levels[-1] * W
                          + rng.randint(0, W, N).astype(np.int32))
        tree = np.stack(levels, axis=0).astype(np.int32)     # [L, N]
        # identical tree for every group: a broadcast VIEW, so the [G, L,
        # N] table costs [L, N] host memory (chunked uploads make shards
        # contiguous on demand)
        p.spread_rank = np.broadcast_to(tree[None], (G, lmax, N))
    else:
        p.spread_rank = np.zeros((G, 0, N), np.int32)
    return p, group_shard


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
