"""Node-axis sharding of the placement and raft kernels on one device
(the port of the JAX package's `parallel/mesh.py`).

The reference maps its scale axes onto a device mesh: per-node arrays shard
over the `nodes` axis, per-manager ack rows over `managers`, and XLA
inserts the collectives (psums for the water levels, capacity sums and
quorum tallies, a gather for the boundary sort). The port checks the same
decomposition on one card as a k-way node split: a `Mesh` is k shards on
one torch device, a sharded array is a list of k per-shard tensors, and the
cross-shard exchange is written out by hand, in the sharded kernels K20-K22
(`parallel/fill.py`, `ops/raft_replay.py`) and their plain versions.
Exchange between cards waits for more than one GPU: shards on two devices
raise.

Not ported: `mesh_context` (PyTorch has no ambient mesh). The resident
tick's shardings (`RESIDENT_STATE_SPECS`, `resident_shardings`,
`node_axis_sharding`) are `ops/resident_mesh.py`'s `MESH_STATE_AXES` and
`GROUP_NODE_AXES`, with its `MeshResidentPlacement`.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..convert import as_tensor, check_kernel_args
from ..device import resolve_device
from ..ops.placement import raise_on_overflow
from ..ops.raft_replay import sharded_replay_tally
from ..scheduler.encode import KERNEL_ARG_FIELDS, kernel_args
from .fill import sharded_schedule_core

NODE_AXIS = "nodes"

# Per-field sharding: (node-axis position or None, pad fill value). Order is
# NOT duplicated here — it comes from KERNEL_ARG_FIELDS.
_FIELD_SHARDING: dict[str, tuple[int | None, object]] = {
    "ready": (0, False),
    "node_val": (0, -1),
    "node_plat": (0, 0),
    "node_plugins": (0, False),
    "extra_mask": (1, False),
    "constraints": (None, 0),
    "plat_req": (None, 0),
    "req_plugins": (None, 0),
    "avail_res": (0, 0),
    "total0": (0, 0),
    "svc_count0": (1, 0),
    "n_tasks": (None, 0),
    "svc_idx": (None, 0),
    "need_res": (None, 0),
    "max_replicas": (None, 0),
    "penalty": (1, False),
    "has_ports": (None, 0),
    "group_ports": (None, 0),
    "port_used0": (0, False),
    # phantom pad nodes fall into segment 0 with zero capacity and zero
    # service counts — invisible to every pour
    "spread_rank": (2, 0),
    # per-group CSI rows — group-side, replicated (the kernel gathers
    # node_val columns by row key, so the node axis never appears here)
    "vol_topo": (None, -1),
}


class Mesh:
    """k shards of one axis on one torch device (the port's counterpart
    of a one-axis `jax.sharding.Mesh`)."""

    def __init__(self, size: int, axis: str, device: torch.device):
        if size < 1:
            raise ValueError(f"a mesh needs at least one shard, got {size}")
        self.size = size
        self.axis = axis
        self.device = device


def make_mesh(n_shards: int | None = None, axis: str = NODE_AXIS,
              device=None) -> Mesh:
    """k shards on `resolve_device(device)`: the card unless
    `device="cpu"` (the plain versions), raising without one. None means
    one shard."""
    return Mesh(1 if n_shards is None else n_shards, axis,
                resolve_device(device))


def _pad_nodes(arr: np.ndarray, n_pad: int, axis: int, fill):
    if n_pad == 0:
        return arr
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, n_pad)
    return np.pad(arr, pad_width, constant_values=fill)


# node-axis arrays at/above this many bytes upload shard by shard, each
# shard sliced (and tail-padded) on demand, instead of one padded
# whole-array host copy: at the 1M-node grid the [G, LMAX, N] spread table
# alone is hundreds of MB, and the padded host copy would double peak memory
CHUNKED_UPLOAD_BYTES = 64 << 20


def _upload(chunk: np.ndarray, mesh: Mesh, stats: dict | None):
    t = as_tensor(np.ascontiguousarray(chunk)).to(mesh.device)
    if stats is not None:
        stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + chunk.nbytes
    return t


def _put_node_sharded(arr: np.ndarray, mesh: Mesh, node_axis: int,
                      fill, n_padded: int, stats: dict | None = None):
    """Ship one node-axis array to the mesh WITHOUT materializing a padded
    whole-array host copy: each shard is sliced (and tail-padded) on
    demand, so peak host staging is one shard. `arr` may be a broadcast
    view — only shard-sized chunks are ever made contiguous. Returns the k
    shard tensors."""
    k = mesh.size
    per = n_padded // k
    n_real = arr.shape[node_axis]
    shards = []
    for b in range(k):
        start, stop = b * per, (b + 1) * per
        idx = [slice(None)] * arr.ndim
        idx[node_axis] = slice(min(start, n_real), min(stop, n_real))
        part = arr[tuple(idx)]
        if stop > n_real:
            shape = list(arr.shape)
            shape[node_axis] = per
            out = np.full(shape, fill, arr.dtype)
            dst = [slice(None)] * arr.ndim
            dst[node_axis] = slice(0, part.shape[node_axis])
            out[tuple(dst)] = part
            part = out
        shards.append(_upload(part, mesh, stats))
    return shards


def _split_nodes(arr: np.ndarray, mesh: Mesh, node_axis: int,
                 stats: dict | None):
    """A padded node-axis array as k shard tensors, one upload each."""
    return [_upload(part, mesh, stats)
            for part in np.split(arr, mesh.size, axis=node_axis)]


def shard_problem(p, mesh: Mesh, stats: dict | None = None,
                  chunked: int | None = None):
    """Place an EncodedProblem's arrays onto the mesh: every per-node axis
    is split into k shards (a list of k tensors), group-side tables are
    replicated (one tensor: one copy on the card). The node count is padded
    to a multiple of k with ineligible phantom nodes (ready=False), which
    the mask kernel excludes, so results are unchanged. Returns (args in
    KERNEL_ARG_FIELDS order, N).

    stats (optional dict) accumulates `h2d_bytes` — the bytes this upload
    moved. Node-axis arrays at/above `chunked` bytes (default
    CHUNKED_UPLOAD_BYTES) upload shard by shard so the padded host copy is
    never materialized whole."""
    if chunked is None:
        chunked = CHUNKED_UPLOAD_BYTES
    values = kernel_args(p)
    check_kernel_args(values)
    k = mesh.size
    N = len(p.node_ids)
    n_pad = (-N) % k

    args = []
    for field, arr in zip(KERNEL_ARG_FIELDS, values):
        node_axis, fill = _FIELD_SHARDING[field]
        if node_axis is None:
            args.append(_upload(arr, mesh, stats))
        elif arr.nbytes >= chunked:
            args.append(_put_node_sharded(arr, mesh, node_axis, fill,
                                          arr.shape[node_axis] + n_pad,
                                          stats))
        else:
            args.append(_split_nodes(_pad_nodes(arr, n_pad, node_axis, fill),
                                     mesh, node_axis, stats))
    return tuple(args), N


def _strategy(p) -> int:
    return 1 if getattr(p, "strategy", "spread") == "binpack" else 0


def _pull_counts(counts, N: int) -> np.ndarray:
    """The k shards' counts back to the host as one int32[G, N]."""
    n = counts[0].shape[1]
    out = np.empty((counts[0].shape[0], n * len(counts)), np.int32)
    for b, c in enumerate(counts):
        out[:, b * n:(b + 1) * n] = c.cpu().numpy()
    return out[:, :N]


def sharded_schedule(p, mesh: Mesh) -> np.ndarray:
    """Run the placement with per-node arrays sharded over the mesh.
    Returns counts[G, N] (numpy, truncated back to the real node count).
    Raises ValueError when a group's capacity sum reaches 2^31."""
    args, N = shard_problem(p, mesh)
    counts, flags, _ = sharded_schedule_core(args, _strategy(p))
    raise_on_overflow(flags.cpu())
    return _pull_counts(counts, N)


def sharded_cluster_step(p, acks, quorum, mesh: Mesh,
                         stats: dict | None = None):
    """The fused flagship step (models.cluster_step) on the mesh: per-node
    placement arrays shard over the node axis, the raft ack matrix shards
    its log axis over the same shards (the tally is elementwise along the
    log; the commit is the first hole over all shards). Returns (counts[G,
    N] numpy, commit_index int). Raises ValueError when a group's capacity
    sum reaches 2^31.

    stats (optional dict) records the split: h2d_bytes, upload_s, fill_s
    (launches and device compute, up to the commit's read, which
    synchronises), pull_s (the counts back) and d2h_bytes."""
    t0 = time.perf_counter()
    args, N = shard_problem(p, mesh, stats=stats)
    k = mesh.size
    acks = np.asarray(acks)
    E = acks.shape[1]
    e_pad = (-E) % k
    if e_pad:
        # padding with un-acked entries can only sit past the commit
        # frontier (the prefix stops at the first hole)
        acks = np.pad(acks, ((0, 0), (0, e_pad)), constant_values=False)
    acks_sh = _split_nodes(acks, mesh, 1, stats)
    if stats is not None:
        stats["upload_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    counts, flags, _ = sharded_schedule_core(args, _strategy(p))
    commit, _ = sharded_replay_tally(acks_sh, quorum, layout="log")
    # the commit's read is the device sync: it delimits fill_s
    commit_i = int(commit)
    raise_on_overflow(flags.cpu())
    if stats is not None:
        stats["fill_s"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    counts_np = _pull_counts(counts, N)
    if stats is not None:
        stats["pull_s"] = time.perf_counter() - t2
        stats["d2h_bytes"] = counts_np.nbytes
    return counts_np, commit_i
