"""The device-resident tick with its carry sharded on the node axis (the
port of the mesh mode of the JAX package's `ResidentPlacement`:
`ops/resident.py` `_mesh_ticks` and the mesh branches of the class, with
`RESIDENT_STATE_SPECS`, `resident_shardings` and `node_axis_sharding` of
`parallel/mesh.py`).

The port's mesh (`parallel/mesh.py`) is a k-way node split of one device: k
shards on one torch device, a sharded array a list of k per-shard tensors.
`MeshResidentPlacement` keeps the one-device tick's carry in that form: each
of the eight STATE_FIELDS is a list of k tensors, the node bucket split into
k shards of n_s = bucket / k nodes (the bucket floors at k; the phantom pad
nodes are never eligible, so the counts are the unsharded problem's). The
per-tick group tables are one tensor each, except the three whose last axis
is the node bucket (penalty, spread ranks, extra mask), which are split the
same way. Everything else is the one-device tick's (`ops/resident.py`): the
signature, the group-table gates, `after_apply` and the pull's byte rule.

A tick runs, on the carry itself:

  * one K23 launch that sets the delta rows (the encoder's dirty rows and
    the `after_apply` corrections, by their global row index) into their
    shards;
  * one K1 launch over every shard (`sharded_static_mask`), then one K20
    (`sharded_water_fill_step`, spread and topology) or K21
    (`sharded_binpack_fill_step`, binpack) launch per group, which fold the
    counts into every shard's carry in place;
  * one K24 launch that pulls the counts: the dense [G, N] window, or the
    sparse (index, value) pack of its nonzeros.

A cold upload splits the node tables on the host and runs K8 once per shard
for an all-zero or sparse service matrix.

Two kernels are this module's own, each a hand-written CUDA kernel under
csrc/ with its plain PyTorch version beside its wrapper (the plain version
runs for CPU tensors only; a CUDA tensor launches the kernel or raises):

  * `sharded_delta_scatter` (K23, csrc/sharded_delta_scatter.cu);
  * `sharded_counts_pull`   (K24, csrc/sharded_counts_pull.cu).
"""
from __future__ import annotations

import functools
import struct

import numpy as np
import torch

from ..parallel.fill import sharded_fill
from ..parallel.mesh import NODE_AXIS, Mesh, make_mesh
from ..scheduler.encode import EncodedProblem, IncrementalEncoder, _bucket
from . import _kernels
from .placement import FillState, FillTables, _expect, sharded_static_mask
from .resident import (
    _I32_LIMIT,
    _PLACEHOLDER_FALSE,
    _PLACEHOLDER_VOLTOPO,
    STATE_FIELDS,
    PendingCounts,
    ResidentPlacement,
    _counts_dtype,
    _pad1,
    sparse_counts_plain,
    svc_matrix_build,
)

# The node-axis position of each carried field (the reference's
# RESIDENT_STATE_SPECS): the seven node tables shard their rows, the
# service matrix [S, N] its columns.
MESH_STATE_AXES = {"ready": 0, "node_val": 0, "node_plat": 0,
                   "node_plugins": 0, "port_used": 0, "avail_res": 0,
                   "total0": 0, "svc_mat": 1}

# Group-table slots split per shard when their last axis is the node bucket
# (slot -> node axis): penalty [G, N], spread ranks [G, L, N], extra mask
# [G, N]. The (1, 1) "off" placeholders stay whole.
GROUP_NODE_AXES = {7: 1, 10: 2, 11: 1}

# The most shards K24 takes: its per-shard pointers ride the launch.
MAX_PULL_SHARDS = 256


# ------------------------------------------------ K23 sharded delta scatter
def _shard_width(state) -> tuple[int, int]:
    return len(state[0]), state[0][0].shape[0]


def sharded_delta_scatter_plain(state, deltas) -> None:
    """Plain PyTorch row scatter into a sharded carry: `state` is the eight
    STATE_FIELDS, each a list of k shard tensors of n rows (the service
    matrix: n columns); `deltas` is K5's (d_idx int32[D] of global rows,
    then the D rows of the seven node tables, then the service columns
    int32[S, D]). Row i goes to shard i // n, local row i % n. Rows outside
    [0, k * n) raise."""
    k, n = _shard_width(state)
    idx = deltas[0].long()
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= k * n):
        raise ValueError(f"delta rows outside [0, {k * n})")
    shard = torch.div(idx, n, rounding_mode="floor")
    local = idx - shard * n
    for b in range(k):
        sel = torch.nonzero(shard == b).reshape(-1)
        if sel.numel() == 0:
            continue
        rows = local[sel]
        for f in range(7):
            state[f][b][rows] = deltas[f + 1][sel]
        state[7][b][:, rows] = deltas[8][:, sel]


def scatter_table(state) -> torch.Tensor:
    """K23's pointer table int64[k, 8]: each shard's eight carry tensors in
    STATE_FIELDS order. The carry's tensors do not move between ticks, so
    a tick keeps its table until the next cold upload."""
    k, _ = _shard_width(state)
    return _kernels.pointer_table(
        [[state[f][b].data_ptr() for f in range(8)] for b in range(k)],
        state[0][0].device)


def _check_scatter(state, deltas) -> tuple[int, ...]:
    """Every shard as K5 takes the one-device state, one width for all."""
    k, n = _shard_width(state)
    if len(state) != 8 or any(len(f) != k for f in state):
        raise ValueError("state: expected the 8 STATE_FIELDS, each a list "
                         f"of {k} shards")
    K = state[1][0].shape[1]
    PL, PV = state[3][0].shape[1], state[4][0].shape[1]
    R, S = state[5][0].shape[1], state[7][0].shape[0]
    D = deltas[0].shape[0]
    shapes = ((torch.bool, (n,)), (torch.int32, (n, K)),
              (torch.int32, (n, 2)), (torch.bool, (n, PL)),
              (torch.bool, (n, PV)), (torch.int32, (n, R)),
              (torch.int32, (n,)), (torch.int32, (S, n)))
    for name, f, (dtype, shape) in zip(STATE_FIELDS, state, shapes):
        for b, t in enumerate(f):
            _expect(t, f"{name}[{b}]", dtype, shape)
    for t, name, dtype, shape in (
            (deltas[0], "d_idx", torch.int32, (D,)),
            (deltas[1], "d_ready", torch.bool, (D,)),
            (deltas[2], "d_val", torch.int32, (D, K)),
            (deltas[3], "d_plat", torch.int32, (D, 2)),
            (deltas[4], "d_plug", torch.bool, (D, PL)),
            (deltas[5], "d_port", torch.bool, (D, PV)),
            (deltas[6], "d_avail", torch.int32, (D, R)),
            (deltas[7], "d_total", torch.int32, (D,)),
            (deltas[8], "d_svc", torch.int32, (S, D))):
        _expect(t, name, dtype, shape)
    if k * n >= _I32_LIMIT:
        raise ValueError(f"{k} x {n} nodes: the row index is int32")
    return k, n, D, K, PL, PV, R, S


def sharded_delta_scatter(state, deltas, table=None) -> None:
    """Set the delta rows into the sharded carry in place, each by its
    global row index: the plain version for CPU tensors, kernel K23
    (csrc/sharded_delta_scatter.cu) for CUDA tensors, one launch for every
    row of every shard. Repeated indices must carry identical rows.
    `table` is `scatter_table(state)`, made here when not given. The
    kernel skips rows outside [0, k * n): the caller checks them on the
    host before the upload."""
    flat = [t for f in state for t in f]
    if _kernels.route("sharded resident", *flat, *deltas) == "plain":
        return sharded_delta_scatter_plain(state, deltas)
    k, n, D, K, PL, PV, R, S = _check_scatter(state, deltas)
    if table is None:
        table = scatter_table(state)
    _expect(table, "table", torch.int64, (k, 8))
    if table.device != deltas[0].device:
        raise ValueError(f"table on {table.device}, the carry on "
                         f"{deltas[0].device}")
    if D == 0:
        return
    rc = _kernels.lib("sharded_delta_scatter").skt_sharded_delta_scatter(
        *(t.data_ptr() or None for t in deltas), table.data_ptr(), D, k, n,
        K, PL, PV, R, S, _kernels.stream_of(deltas[0]))
    _kernels.check(rc, "sharded_delta_scatter")
    sharded_delta_scatter.launches += 1


sharded_delta_scatter.launches = 0


# -------------------------------------------------- K24 sharded counts pull
def sharded_counts_pull_plain(counts, g: int, n: int, compact: bool,
                              k: int | None = None):
    """Plain PyTorch pull of the real [g, n] window of k shard counts
    int32[G, n_s] (global column s * n_s + j): the dense window, int16
    when compact, or with `k` the sparse pack of its nonzeros (ascending
    flat indices padded with index 0, and their values)."""
    joined = torch.cat([c[:g] for c in counts], dim=1)[:, :n].contiguous()
    if k is None:
        return joined.to(_counts_dtype(compact))
    return sparse_counts_plain(joined, g, n, k, compact)


def _check_pull(counts, g: int, n: int) -> tuple[int, int]:
    ks = len(counts)
    if not 1 <= ks <= MAX_PULL_SHARDS:
        raise ValueError(f"{ks} shards: the pull takes 1 to "
                         f"{MAX_PULL_SHARDS}")
    shape = counts[0].shape
    if len(shape) != 2 or not all(
            c.dtype is torch.int32 and c.shape == shape and c.is_contiguous()
            for c in counts):           # find the first fault, in order
        Gc, ns = shape if len(shape) == 2 else (-1, -1)
        for b, c in enumerate(counts):
            _expect(c, f"counts[{b}]", torch.int32, (Gc, ns))
    Gc, ns = shape
    if not (0 <= g <= Gc and 0 <= n <= ks * ns):
        raise ValueError(f"window [{g}, {n}] outside {ks} shards of "
                         f"[{Gc}, {ns}]")
    return ks, ns


def pull_vector(ptrs, dst: int, n: int, n_shard: int) -> bool:
    """Whether K24's dense form takes its vector path (4 cells a thread,
    16-byte loads) for a window n columns wide out of shards n_shard
    columns wide, from the shard addresses `ptrs` to the address dst: only
    when every shard row starts on a 16-byte boundary and every window row
    and shard segment on a 4-cell one (all addresses 16-byte aligned, n and
    n_shard multiples of 4)."""
    if n % 4 or n_shard % 4:
        return False
    bits = dst
    for p in ptrs:
        bits |= p
    return bits % 16 == 0


@functools.cache
def shard_pointers(k: int) -> struct.Struct:
    """The packer of k shard addresses into the host array of pointers
    K24's C entries read (k native 64-bit words): `.pack(*ptrs)`, cheaper
    than building a ctypes array."""
    return struct.Struct(f"{k}Q")


@functools.cache
def _pull_entries():
    """K24's C entries, resolved once: (dense scalar path, dense vector
    path, sparse)."""
    lib = _kernels.lib("sharded_counts_pull")
    return (lib.skt_sharded_counts_dense, lib.skt_sharded_counts_dense_vec4,
            lib.skt_sharded_counts_sparse)


def sharded_counts_pull(counts, g: int, n: int, compact: bool,
                        k: int | None = None):
    """The real [g, n] window of the shards' counts (k tensors int32[G,
    n_s], global column s * n_s + j) in one launch: the dense window
    (int16 when compact), or, with `k`, (idx int32[k], values[k]) of its
    nonzero cells, flat indices ascending and padded with index 0 and cell
    0's value, as the one-device K7 gives them on the joined counts. The
    plain version for CPU tensors, kernel K24 (csrc/sharded_counts_pull.cu)
    for CUDA tensors."""
    if _kernels.route("sharded resident", *counts) == "plain":
        return sharded_counts_pull_plain(counts, g, n, compact, k)
    ks, ns = _check_pull(counts, g, n)
    ptrs = [c.data_ptr() for c in counts]
    shards = shard_pointers(ks).pack(*ptrs)
    dense, dense_vec4, sparse = _pull_entries()
    c0 = counts[0]
    dtype = _counts_dtype(compact)
    stream = _kernels.raw_stream(c0)
    if k is None:
        out = c0.new_empty((g, n), dtype=dtype)
        if g * n == 0:
            return out
        dst = out.data_ptr()
        launch = dense_vec4 if pull_vector(ptrs, dst, n, ns) else dense
        rc = launch(shards, dst, g, n, ns, ks, int(compact), stream)
        result = out
    else:
        if g * n == 0 or k < 1:
            raise ValueError(f"sparse pack of an empty window [{g}, {n}] "
                             f"or k={k}")
        if g * n >= _I32_LIMIT:
            raise ValueError(f"window of {g * n} cells: flat indices need "
                             "int32")
        scratch = c0.new_empty(g * ks + 2)
        idx = c0.new_empty(k)
        vals = c0.new_empty(k, dtype=dtype)
        rc = sparse(shards, idx.data_ptr(), vals.data_ptr(),
                    scratch.data_ptr(), g, n, ns, ks, k, int(compact), stream)
        result = (idx, vals)
    _kernels.check(rc, "sharded_counts_pull")
    sharded_counts_pull.launches += 1
    return result


sharded_counts_pull.launches = 0


# ------------------------------------------------------------- the tick
class MeshResidentPlacement(ResidentPlacement):
    """The resident tick over a node-sharded carry: the counterpart of the
    JAX package's `ResidentPlacement(enc, mesh=...)`.

    `mesh` is a `parallel.mesh.Mesh` on the "nodes" axis, or a shard count
    for `make_mesh` on the card (None means one shard; without a CUDA
    device it raises); the device is the mesh's. Its shard count must be a
    power of two, so that it divides the node bucket. Used as the
    one-device tick is (and under `TickPipeline`); `pull_state()` joins
    the shards."""

    def __init__(self, encoder: IncrementalEncoder, mesh=None):
        if not isinstance(mesh, Mesh):
            mesh = make_mesh(mesh)
        k = mesh.size
        if k & (k - 1):
            raise ValueError(f"mesh node axis must be a power of two, got "
                             f"{k} shards")
        if mesh.axis != NODE_AXIS:
            raise ValueError(f"the carry shards on the {NODE_AXIS!r} axis, "
                             f"not {mesh.axis!r}")
        super().__init__(encoder, device=mesh.device)
        self.mesh = mesh
        self._table = None      # K23's pointer table of the carry
        self._n_branches = 1    # one past the spread table's largest id

    # ------------------------------------------------------------ internals
    def _padded_dims(self, p: EncodedProblem) -> tuple:
        """The one-device buckets, the node bucket floored at the shard
        count so that the shards divide it evenly."""
        return ((_bucket(len(p.node_ids), floor=self.mesh.size),)
                + ResidentPlacement._padded_dims(p)[1:])

    def _split(self, a: np.ndarray, axis: int) -> list:
        """A padded host array as k shard tensors on the device."""
        return [self._to_device(part)
                for part in np.split(a, self.mesh.size, axis=axis)]

    def _upload_full(self, p: EncodedProblem):
        np_b, kp, plp, pvp, rp, sp = self._padded_dims(p)
        k = self.mesh.size
        ns = np_b // k
        n = len(p.node_ids)
        host = [
            self._pad2(p.ready, np_b, fill=False),
            self._pad2(p.node_val, np_b, kp),
            self._pad2(p.node_plat, np_b, 2),
            self._pad2(p.node_plugins, np_b, plp, fill=False),
            self._pad2(p.port_used0, np_b, pvp, fill=False),
            self._pad2(p.avail_res, np_b, rp),
            self._pad2(p.total0, np_b),
        ]
        state = [self._split(a, 0) for a in host]
        self.uploads_h2d_bytes += sum(a.nbytes for a in host)
        # the service matrix: K8 a shard from nothing or from the shard's
        # nonzero cells (column made local), dense only when it is dense;
        # the reference's branches and margin
        svc = self._svc_block(slice(None), sp)
        nnz = int(np.count_nonzero(svc))
        empty = torch.zeros(0, dtype=torch.int32, device=self.device)
        if nnz == 0:
            svc_dev = [svc_matrix_build(empty, empty, sp, ns)
                       for _ in range(k)]
            self.uploads_svc["zeros"] += 1
        elif nnz * 3 * 4 < svc.size:
            r, c = np.nonzero(svc)
            vals = svc[r, c]
            shard = c // ns
            svc_dev = []
            for b in range(k):
                sel = shard == b
                if not sel.any():
                    svc_dev.append(svc_matrix_build(empty, empty, sp, ns))
                    continue
                flat = (r[sel].astype(np.int64) * ns
                        + (c[sel] - b * ns)).astype(np.int32)
                svc_dev.append(svc_matrix_build(
                    self._to_device(flat), self._to_device(vals[sel]), sp,
                    ns))
            self.uploads_h2d_bytes += 2 * 4 * nnz
            self.uploads_svc["sparse"] += 1
        else:
            pad = np.ascontiguousarray(np.pad(svc, ((0, 0), (0, np_b - n))))
            svc_dev = self._split(pad, 1)
            self.uploads_h2d_bytes += pad.nbytes
            self.uploads_svc["dense"] += 1
        state.append(svc_dev)
        self._state = tuple(state)
        self._table = None
        self._meta = self._signature(p)
        self._pending = np.zeros(0, np.int64)
        self._stale = False
        self.uploads_full += 1

    def _scatter_table(self):
        if self._table is None and self.device.type == "cuda":
            self._table = scatter_table(self._state)
        return self._table

    # ------------------------------------------------------------------ API
    def schedule_async(self, p: EncodedProblem) -> PendingCounts:
        """Dispatch one tick over the sharded carry and start the counts'
        copy to the host without blocking; `PendingCounts.get()` waits."""
        enc = self.enc
        G, N = p.extra_mask.shape
        k = self.mesh.size

        if self.needs_full_upload(p):
            self._upload_full(p)
            dirty = np.zeros(0, np.int64)
        else:
            dirty = np.union1d(self._pending, enc.last_dirty_rows) \
                .astype(np.int64)
            self._pending = np.zeros(0, np.int64)

        np_b, kp, plp, pvp, rp, sp = self._padded_dims(p)
        ns = np_b // k
        has_deltas = dirty.size > 0
        if has_deltas:
            if dirty[0] < 0 or dirty[-1] >= np_b:
                raise ValueError(f"delta rows outside [0, {np_b})")
            db = _bucket(dirty.size)
            # the padding repeats the first dirty row with its own data
            idx = np.full(db, dirty[0], np.int64)
            idx[:dirty.size] = dirty
            deltas = [
                idx.astype(np.int32),
                p.ready[idx],
                self._pad2(p.node_val[idx], db, kp),
                p.node_plat[idx],
                self._pad2(p.node_plugins[idx], db, plp, fill=False),
                self._pad2(p.port_used0[idx], db, pvp, fill=False),
                self._pad2(p.avail_res[idx], db, rp),
                p.total0[idx],
                np.ascontiguousarray(self._svc_block(idx, sp)),
            ]
            self.uploads_delta_rows += int(dirty.size)
        else:
            deltas = []

        # the encoder-stamped flags replace O(G*N) scans (None = unknown)
        use_penalty = (bool(p.penalty_nonzero)
                       if p.penalty_nonzero is not None
                       else bool(p.penalty.any()))
        use_extra = ((not p.extra_mask_all)
                     if p.extra_mask_all is not None
                     else not bool(p.extra_mask.all()))
        vt = getattr(p, "vol_topo", None)
        vt_any = getattr(p, "vol_topo_any", None)
        use_voltopo = (bool(vt_any) if vt_any is not None
                       else vt is not None and vt.shape[1] > 0)
        gp = _bucket(G)
        pad2 = self._pad2
        lmax = p.spread_rank.shape[1]
        lp = _bucket(lmax) if lmax else 0
        vp = _bucket(vt.shape[1]) if use_voltopo else 0
        dims = (gp, np_b, kp, plp, pvp, rp, lp, vp, N)
        strategy = 1 if getattr(p, "strategy", "spread") == "binpack" else 0

        # values the kernels index with, checked on the host
        max_nt = int(p.n_tasks.max()) if p.n_tasks.size else 0
        svc_idx = p.svc_idx_persistent
        if svc_idx.size and (svc_idx.min() < 0 or svc_idx.max() >= sp):
            raise ValueError(f"svc_idx_persistent outside [0, {sp})")

        def build_slot(i):
            if i == 0:
                return pad2(p.constraints, gp, fill=-1)
            if i == 1:
                return pad2(p.plat_req, gp, fill=-2)
            if i == 2:
                return pad2(p.req_plugins, gp, plp, fill=False)
            if i == 3:
                return pad2(p.n_tasks, gp)
            if i == 4:
                return _pad1(p.svc_idx_persistent, gp)
            if i == 5:
                return pad2(p.need_res, gp, rp)
            if i == 6:
                return pad2(p.max_replicas, gp)
            if i == 7:
                return pad2(p.penalty, gp, np_b, fill=False)
            if i == 8:
                return pad2(p.has_ports, gp, fill=False)
            if i == 9:
                return pad2(p.group_ports, gp, pvp, fill=False)
            if i == 10:
                spread = np.zeros((gp, lp, np_b), np.int32)
                # K20's branch slots: one past the largest branch id, as
                # the one-shot loop's range check reads it
                self._n_branches = 1
                if lmax and G:
                    lo, hi = int(p.spread_rank.min()), \
                        int(p.spread_rank.max())
                    if lo < 0 or hi >= N:
                        raise ValueError(f"spread_rank outside [0, {N})")
                    self._n_branches = hi + 1
                    spread[:G, :lmax, :N] = p.spread_rank
                    if lp > lmax:
                        # replicate each group's deepest real level
                        # (self-parented pours are no-ops), like
                        # pad_buckets
                        spread[:G, lmax:, :N] = \
                            p.spread_rank[:, lmax - 1:lmax, :]
                return spread
            if i == 11:
                return pad2(p.extra_mask, gp, np_b, fill=False)
            return pad2(vt, gp, vp, fill=-1)                     # 12

        compact = bool(max_nt < (1 << 15))

        # the one-device tick's group-table cache (identity gate, then
        # value gate); a slot of GROUP_NODE_AXES keeps its k shard tensors
        srcs = [p.constraints, p.plat_req, p.req_plugins, p.n_tasks,
                p.svc_idx_persistent, p.need_res, p.max_replicas,
                p.penalty if use_penalty else _PLACEHOLDER_FALSE,
                p.has_ports, p.group_ports, p.spread_rank,
                p.extra_mask if use_extra else _PLACEHOLDER_FALSE,
                vt if use_voltopo else _PLACEHOLDER_VOLTOPO]
        n_slots = len(srcs)
        cache = self._gcache
        prev_src = self._gsrc
        if cache is None or len(cache) != n_slots or self._gdims != dims:
            cache = [None] * n_slots
            prev_src = [None] * n_slots
        group_dev: list = [None] * n_slots
        group_host: list = [None] * n_slots
        ship_slots: list[int] = []
        to_ship: list[np.ndarray] = []
        for i, src in enumerate(srcs):
            c = cache[i]
            if c is not None and prev_src[i] is src:
                group_host[i], group_dev[i] = c          # identity hit
                continue
            h = (src if src is _PLACEHOLDER_FALSE
                 or src is _PLACEHOLDER_VOLTOPO else build_slot(i))
            group_host[i] = h
            if c is not None and c[0].shape == h.shape \
                    and c[0].dtype == h.dtype and np.array_equal(c[0], h):
                group_dev[i] = c[1]
            else:
                ship_slots.append(i)
                to_ship.append(h)
        for slot, h in zip(ship_slots, to_ship):
            ax = GROUP_NODE_AXES.get(slot)
            if ax is not None and h.shape[-1] == np_b:
                group_dev[slot] = self._split(h, ax)
            else:
                group_dev[slot] = self._to_device(h)
        self._gcache = list(zip(group_host, group_dev))
        self._gsrc = srcs
        self._gdims = dims
        self.uploads_group_tables += len(ship_slots)
        self.uploads_h2d_bytes += sum(a.nbytes for a in deltas) \
            + sum(a.nbytes for a in to_ship)

        if has_deltas:
            sharded_delta_scatter(self._state,
                                  [self._to_device(a) for a in deltas],
                                  self._scatter_table())
        (ready, node_val, node_plat, node_plugins, port_used, avail_res,
         total0, svc_mat) = self._state
        pen_off, extra_on, vt_off = self._off_tables(
            gp, ns, _PLACEHOLDER_VOLTOPO.shape[2])

        # padded groups (n_tasks 0) place and fold nothing: the fill runs
        # the real ones only, on row views of the padded tables
        def rows(t):
            return [x[:G] for x in t] if isinstance(t, list) else t[:G]

        (constraints, plat_req, req_plugins, n_tasks, svc_idx_d, need_res,
         max_replicas, penalty, has_ports, group_ports, spread_rank, extra,
         vol_topo) = (rows(t) for t in group_dev)
        penalty = penalty if use_penalty else [pen_off[:G]] * k
        extra = extra if use_extra else [extra_on[:G]] * k
        vol_topo = vol_topo if use_voltopo else vt_off[:G]
        masks = sharded_static_mask(ready, node_val, node_plat,
                                    node_plugins, constraints, plat_req,
                                    req_plugins, extra, vol_topo)
        tables = [FillTables(
            masks[b], need_res, n_tasks, svc_idx_d, max_replicas,
            penalty[b], has_ports, group_ports, spread_rank[b])
            for b in range(k)]
        # the steps fold into the carry in place
        states = [FillState(total0[b], svc_mat[b], avail_res[b],
                            port_used[b]) for b in range(k)]
        counts, flags = sharded_fill(tables, states, strategy,
                                     self._n_branches)
        # pull form: dense [G, N] window vs sparse (idx, val), by bytes
        total = int(p.n_tasks.sum())
        kk = _bucket(max(total, 1))
        dense_bytes = G * N * (2 if compact else 4)
        sparse_bytes = kk * (4 + (2 if compact else 4))
        if kk < G * N and sparse_bytes < dense_bytes:
            self.pulls["sparse"] += 1
            return PendingCounts(
                (*sharded_counts_pull(counts, G, N, compact, kk), flags),
                (G, N), on_refuse=self.invalidate)
        self.pulls["dense"] += 1
        return PendingCounts(
            (sharded_counts_pull(counts, G, N, compact), flags),
            on_refuse=self.invalidate)

    # ------------------------------------------------------------ debugging
    def pull_state(self) -> dict:
        """The sharded carry joined on its node axis, as numpy copies keyed
        by STATE_FIELDS (the reference's carry as one array)."""
        return {f: torch.cat([t.to("cpu") for t in shards],
                             dim=MESH_STATE_AXES[f]).numpy()
                for f, shards in zip(STATE_FIELDS, self._state)}
