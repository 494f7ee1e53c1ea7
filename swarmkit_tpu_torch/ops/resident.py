"""Device-resident incremental scheduling state (the port of the JAX
package's `ops/resident.py`, single device).

The one-shot path (`ops.placement.schedule_encoded`) ships every [N]-sized
table to the card on every wave. `ResidentPlacement` keeps the node-side
tables on the card across ticks instead:

  * a tick sets in only the rows the encoder re-encoded since the last
    tick (`IncrementalEncoder.last_dirty_rows`, plus the quantization
    corrections queued by `after_apply`), runs the placement, and keeps
    the post-placement node state as the next tick's carry. The fill
    updates that state in place (`placement.schedule_core`), which is what
    the JAX package gets from donating the state buffers;
  * the kernels' own fold (totals += counts, avail -= counts * need, service
    rows, port ORs) is exactly the fold the host applies after a tick
    (`IncrementalEncoder.apply_counts`), so in the common case nothing
    node-sized crosses the link: deltas up, a counts window down;
  * the per-tick group tables sit behind a cache with an identity gate (the
    encoder re-emits unchanged tables as the same object) and a value gate
    (a memcmp of the padded copy), so only what changed ships.

The host stays authoritative: `apply_counts` subtracts RAW reservations and
re-derives the quantized columns, while the kernels subtract QUANTIZED needs,
and the two differ by one quantum on nodes whose reservation is not a
quantum multiple. `after_apply` predicts the card's value with numpy, diffs
it against the encoder's, and queues only the divergent rows for the next
tick.

Four kernels of this module carry the tick beside the placement kernels
K1-K3 and K9 (binpack) (each a hand-written CUDA kernel under csrc/ with its plain PyTorch
version beside its wrapper; the plain version runs for CPU tensors only):

  * `resident_delta_scatter` (K5) — the row deltas into the state;
  * `counts_window`          (K6) — the real [G, N] window of the counts,
                                    int16 when compact (the dense pull);
  * `sparse_counts`          (K7) — the window's nonzeros as ascending
                                    (flat index, value) pairs (the sparse
                                    pull, for node-heavy ticks);
  * `svc_matrix_build`       (K8) — the [S, N] service matrix of a cold
                                    upload, from zeros or a sparse
                                    scatter-add.

The JAX package's `mesh=` mode, the carry sharded on the node axis, is
`ops/resident_mesh.py` `MeshResidentPlacement`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..convert import as_tensor
from ..device import resolve_device
from ..scheduler.encode import (
    VOL_TOPO_SEGS,
    EncodedProblem,
    IncrementalEncoder,
    _bucket,
)
from . import _kernels
from .placement import (
    FillState,
    _expect,
    _ptr,
    raise_on_overflow,
    schedule_core,
)

# node-state tensors kept on the card, in this order
STATE_FIELDS = ("ready", "node_val", "node_plat", "node_plugins",
                "port_used", "avail_res", "total0", "svc_mat")

# module-singleton placeholders for the disabled penalty/extra/vol-topo
# group tables: a FRESH (1, 1) array per tick would defeat the group-table
# cache's identity gate and re-ship them every steady tick. They stand for
# "off" and are never handed to a kernel as data.
_PLACEHOLDER_FALSE = np.zeros((1, 1), bool)
_PLACEHOLDER_VOLTOPO = np.full((1, 1, 1 + 2 * VOL_TOPO_SEGS), -1, np.int32)

_I32_LIMIT = 1 << 31


# --------------------------------------------------- K5 delta scatter
def resident_delta_scatter_plain(state, deltas) -> None:
    """Plain PyTorch row scatter: `deltas` is (d_idx int32[D], then the D
    rows of the first seven STATE_FIELDS arrays, then the service columns
    int32[S, D]); sets them into `state` in place."""
    idx = deltas[0].long()
    for arr, rows in zip(state[:7], deltas[1:8]):
        arr[idx] = rows
    state[7][:, idx] = deltas[8]


def resident_delta_scatter(state, deltas) -> None:
    """Set the delta rows into the resident state in place: the plain
    version for CPU tensors, kernel K5 (csrc/resident_delta_scatter.cu)
    for CUDA tensors. Repeated indices must carry identical rows."""
    if _kernels.route("resident", *state, *deltas) == "plain":
        return resident_delta_scatter_plain(state, deltas)
    (ready, node_val, node_plat, node_plugins, port_used, avail_res, total0,
     svc_mat) = state
    N, K = node_val.shape
    PL, PV = node_plugins.shape[1], port_used.shape[1]
    R, S = avail_res.shape[1], svc_mat.shape[0]
    D = deltas[0].shape[0]
    for t, name, dtype, shape in (
            (ready, "ready", torch.bool, (N,)),
            (node_val, "node_val", torch.int32, (N, K)),
            (node_plat, "node_plat", torch.int32, (N, 2)),
            (node_plugins, "node_plugins", torch.bool, (N, PL)),
            (port_used, "port_used", torch.bool, (N, PV)),
            (avail_res, "avail_res", torch.int32, (N, R)),
            (total0, "total0", torch.int32, (N,)),
            (svc_mat, "svc_mat", torch.int32, (S, N)),
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
    if D == 0:
        return
    rc = _kernels.lib("resident_delta_scatter").skt_resident_delta_scatter(
        *(_ptr(t) for t in deltas), *(_ptr(t) for t in state),
        D, N, K, PL, PV, R, S, _kernels.stream_of(total0))
    _kernels.check(rc, "resident_delta_scatter")
    resident_delta_scatter.launches += 1


resident_delta_scatter.launches = 0


# --------------------------------------------------- K6 counts window
def _counts_dtype(compact: bool):
    return torch.int16 if compact else torch.int32


def counts_window_plain(counts, g: int, n: int, compact: bool):
    """Plain PyTorch [:g, :n] window of the padded counts, contiguous,
    int16 when compact."""
    return counts[:g, :n].to(_counts_dtype(compact)).contiguous()


def _check_counts(counts, g: int, n: int) -> None:
    if counts.dtype != torch.int32 or counts.dim() != 2:
        raise TypeError(f"counts: expected int32[Gp, Np], got {counts.dtype}"
                        f"{list(counts.shape)}")
    if not counts.is_contiguous():
        raise ValueError("counts: not contiguous")
    if not (0 <= g <= counts.shape[0] and 0 <= n <= counts.shape[1]):
        raise ValueError(f"window [{g}, {n}] outside counts "
                         f"{list(counts.shape)}")


def window_vector(src: int, dst: int, n: int, n_pad: int) -> bool:
    """Whether K6 takes its vector path (4 cells a thread, 16-byte loads)
    for a window of n columns out of counts rows of n_pad, between the
    addresses src and dst: only when every row of both arrays starts on a
    16-byte boundary."""
    return n % 4 == 0 and n_pad % 4 == 0 and src % 16 == 0 and dst % 16 == 0


@functools.cache
def _counts_window_entries():
    """K6's C entries, resolved once: (scalar path, vector path)."""
    lib = _kernels.lib("counts_window")
    return lib.skt_counts_window, lib.skt_counts_window_vec4


def counts_window(counts, g: int, n: int, compact: bool):
    """The real [g, n] window of int32 counts[Gp, Np] as one contiguous
    tensor, int16 when compact: the plain version for CPU tensors, kernel K6
    (csrc/counts_window.cu) for CUDA tensors."""
    if _kernels.route("resident", counts) == "plain":
        return counts_window_plain(counts, g, n, compact)
    _check_counts(counts, g, n)
    out = counts.new_empty((g, n), dtype=_counts_dtype(compact))
    if g * n == 0:
        return out
    src, dst, n_pad = counts.data_ptr(), out.data_ptr(), counts.shape[1]
    scalar, vec4 = _counts_window_entries()
    launch = vec4 if window_vector(src, dst, n, n_pad) else scalar
    rc = launch(src, dst, g, n, n_pad, int(compact),
                _kernels.raw_stream(counts))
    _kernels.check(rc, "counts_window")
    counts_window.launches += 1
    return out


counts_window.launches = 0


# --------------------------------------------------- K7 sparse counts
def sparse_counts_plain(counts, g: int, n: int, k: int, compact: bool):
    """Plain PyTorch sparse pack of the [g, n] window: (flat indices of the
    nonzeros, ascending, padded with index 0 to k; their values, int16 when
    compact)."""
    flat = counts[:g, :n].reshape(-1)
    nz = torch.nonzero(flat).reshape(-1)[:k]
    idx = torch.zeros(k, dtype=torch.int64, device=counts.device)
    idx[:nz.numel()] = nz
    return idx.to(torch.int32), flat[idx].to(_counts_dtype(compact))


def sparse_counts(counts, g: int, n: int, k: int, compact: bool):
    """(idx int32[k], values[k]) of the nonzero cells of counts[:g, :n],
    flat indices ascending and padded with index 0 (and cell 0's value):
    the plain version for CPU tensors, kernel K7 (csrc/sparse_counts.cu)
    for CUDA tensors."""
    if _kernels.route("resident", counts) == "plain":
        return sparse_counts_plain(counts, g, n, k, compact)
    _check_counts(counts, g, n)
    if g * n == 0 or k < 1:
        raise ValueError(f"sparse pack of an empty window [{g}, {n}] "
                         f"or k={k}")
    if g * n >= _I32_LIMIT:
        raise ValueError(f"window of {g * n} cells: flat indices need "
                         "int32")
    dev = counts.device
    cdll = _kernels.lib("sparse_counts")
    tile = cdll.skt_sparse_counts_tile()
    scratch = torch.empty((g * n + tile - 1) // tile + 1, dtype=torch.int32,
                          device=dev)
    idx = torch.empty(k, dtype=torch.int32, device=dev)
    vals = torch.empty(k, dtype=_counts_dtype(compact), device=dev)
    rc = cdll.skt_sparse_counts(
        _ptr(counts), _ptr(idx), _ptr(vals), _ptr(scratch), g, n,
        counts.shape[1], k, int(compact), _kernels.stream_of(counts))
    _kernels.check(rc, "sparse_counts")
    sparse_counts.launches += 1
    return idx, vals


sparse_counts.launches = 0


# ------------------------------------------------- K8 svc matrix build
def svc_matrix_build_plain(idx, vals, rows: int, cols: int):
    """Plain PyTorch zeros[rows * cols] + flat scatter-add of (idx, vals),
    viewed as int32[rows, cols]."""
    out = torch.zeros(rows * cols, dtype=torch.int32, device=idx.device)
    out.index_add_(0, idx.long(), vals)
    return out.view(rows, cols)


@functools.cache
def _svc_matrix_build_entry():
    """K8's C entry, resolved once."""
    return _kernels.lib("svc_matrix_build").skt_svc_matrix_build


def svc_matrix_build(idx, vals, rows: int, cols: int):
    """The [rows, cols] service matrix from its nonzero cells (flat int32
    indices, int32 values; none for the all-zero matrix), made on idx's
    device: the plain version for CPU tensors, kernel K8
    (csrc/svc_matrix_build.cu) for CUDA tensors."""
    if _kernels.route("resident", idx, vals) == "plain":
        return svc_matrix_build_plain(idx, vals, rows, cols)
    nnz = idx.shape[0]
    if not (idx.dtype is vals.dtype is torch.int32 and idx.dim() == 1
            and vals.shape == idx.shape and idx.is_contiguous()
            and vals.is_contiguous()):    # find the first fault, in order
        _expect(idx, "idx", torch.int32, (nnz,))
        _expect(vals, "vals", torch.int32, (nnz,))
    cells = rows * cols
    if cells >= _I32_LIMIT:
        raise ValueError(f"{rows} x {cols} cells: flat indices need int32")
    out = idx.new_empty((rows, cols))
    rc = _svc_matrix_build_entry()(idx.data_ptr(), vals.data_ptr(),
                                   out.data_ptr(), cells, nnz,
                                   _kernels.raw_stream(idx))
    _kernels.check(rc, "svc_matrix_build")
    svc_matrix_build.launches += 1
    return out


svc_matrix_build.launches = 0


# ------------------------------------------------------------ the pull
class PendingCounts:
    """Handle to a dispatched tick's counts, the copy to the host already
    under way.

    `tensors` is the window (dense) or the (idx, values) pair (sparse),
    then the steps' overflow flags int32[G]. On the card all of them are
    copied into pinned host memory without blocking, and one CUDA event is
    recorded after the copies; `get()` waits on that event only. On the CPU
    the tensors are the result and nothing waits. `get()` raises ValueError
    when a flag is set, after calling `on_refuse` (the resident placement
    marks its carry stale: the refused group folded nothing on the card)."""

    __slots__ = ("_host", "_event", "_shape", "_out", "_on_refuse")

    def __init__(self, tensors: tuple, shape=None, on_refuse=None):
        self._shape = shape          # (G, N) -> sparse; None -> dense
        self._out = None
        self._on_refuse = on_refuse
        dev = tensors[0].device
        if dev.type == "cuda":
            self._host = tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors)
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))
        else:
            self._host = tensors
            self._event = None

    def get(self) -> np.ndarray:
        """Wait for the counts; returns int32[G, N]. Idempotent."""
        if self._out is None:
            if self._event is not None:
                self._event.synchronize()
                self._event = None
            *counts, flags = self._host
            if flags.numpy().any():
                if self._on_refuse is not None:
                    self._on_refuse()
                raise_on_overflow(flags.numpy())
            if self._shape is None:
                self._out = counts[0].numpy().astype(np.int32)
            else:
                idx, val = (t.numpy() for t in counts)
                g, n = self._shape
                dense = np.zeros(g * n, np.int32)
                dense[idx] = val     # padding rewrites cell 0's own value
                self._out = dense.reshape(g, n)
            self._host = None
        return self._out


class ResidentPlacement:
    """Owns the card's copy of one IncrementalEncoder's node tables.

    Usage (what a scheduler tick does):
        counts = rp.schedule(problem)          # problem from enc.encode()
        ... the scheduler applies, enc.apply_counts(problem, counts) ...
        rp.after_apply(problem, counts)        # or rp.invalidate()

    Runs on the card unless `device="cpu"`, where every kernel is its plain
    PyTorch version; with no device given and no CUDA device it raises.
    """

    def __init__(self, encoder: IncrementalEncoder, device=None):
        self.enc = encoder
        self.device = resolve_device(device)
        self._state = None          # tuple of tensors, STATE_FIELDS order
        self._meta = None           # bucket/vocab signature of the state
        self._pending = np.zeros(0, np.int64)  # rows to upload next tick
        self._stale = True
        self.uploads_full = 0       # observability
        self.uploads_delta_rows = 0
        self.uploads_group_tables = 0
        self.uploads_h2d_bytes = 0  # bytes shipped to the device
        # which svc-matrix branch each full upload took, and which form each
        # counts pull took
        self.uploads_svc = {"zeros": 0, "sparse": 0, "dense": 0}
        self.pulls = {"dense": 0, "sparse": 0}
        self._gcache = None         # [(host array, tensor)] per slot
        self._gsrc = None           # per-slot SOURCE object (identity gate)
        self._gdims = None          # padded dims + N the cache was built at
        self._off = None            # (dims, penalty off, extra on, no vt)

    # ------------------------------------------------------------ internals
    def _signature(self, p: EncodedProblem) -> tuple:
        """Everything that forces a full re-upload when it changes.

        Node-id remaps are handled via enc.last_remap. A new constraint KEY
        backfills a node_val column for every row, so key-set size is here;
        value-vocab growth touches no existing row and is deliberately
        absent. Plugin/port/kind vocab growth widens the respective arrays,
        so their shapes cover it. Service-row growth inside the Sp bucket
        is delta-safe (new rows start zero on both sides); only crossing
        the bucket re-uploads."""
        return (
            len(p.node_ids),
            len(self.enc.key_cols),
            _bucket(max(p.n_svc_rows, 1)),
            p.node_val.shape[1], p.node_plugins.shape[1],
            p.port_used0.shape[1], p.avail_res.shape[1],
        )

    def _svc_block(self, cols, sp: int) -> np.ndarray:
        """Persistent service matrix columns, padded to the Sp bucket."""
        enc = self.enc
        block = enc._svc_mat[:len(enc._svc_row), cols]
        if block.shape[0] < sp:
            block = np.concatenate(
                [block, np.zeros((sp - block.shape[0],) + block.shape[1:],
                                 np.int32)], axis=0)
        return block

    @staticmethod
    def _padded_dims(p: EncodedProblem) -> tuple:
        """Bucketed (N, K, PL, PV, R, S), as pad_buckets pads them, so the
        node state lines up with the per-tick group tables."""
        return (_bucket(len(p.node_ids)),
                _bucket(p.node_val.shape[1]),
                _bucket(p.node_plugins.shape[1]),
                _bucket(p.port_used0.shape[1]),
                _bucket(p.avail_res.shape[1]),
                _bucket(max(p.n_svc_rows, 1)))

    @staticmethod
    def _pad2(a: np.ndarray, rows: int, cols: int | None = None,
              fill=0) -> np.ndarray:
        shape = (rows,) + ((cols,) + a.shape[2:] if cols is not None
                           else a.shape[1:])
        if a.shape == shape:
            return a
        out = np.full(shape, fill, a.dtype)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A private copy of `a` on the device. On the card it goes through
        pinned memory without blocking: a copy from pageable memory would
        wait for the kernels still queued on the stream."""
        t = as_tensor(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _upload_full(self, p: EncodedProblem):
        np_b, kp, plp, pvp, rp, sp = self._padded_dims(p)
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
        state = [self._to_device(a) for a in host]
        self.uploads_h2d_bytes += sum(a.nbytes for a in host)
        # the [S, N] service matrix is the cold upload's whale, and on a
        # cold cluster it is all zeros or nearly so: make it on the card
        # (K8) from nothing or from its nonzero cells, and ship it dense
        # only when it is dense. Sparse ships 8 bytes per nonzero against
        # 4 per cell; the 12x margin is the reference's.
        svc = self._svc_block(slice(None), sp)
        nnz = int(np.count_nonzero(svc))
        if nnz == 0:
            empty = torch.zeros(0, dtype=torch.int32, device=self.device)
            svc_dev = svc_matrix_build(empty, empty, sp, np_b)
            self.uploads_svc["zeros"] += 1
        elif nnz * 3 * 4 < svc.size:
            r, c = np.nonzero(svc)
            flat = (r.astype(np.int64) * np_b + c).astype(np.int32)
            vals = svc[r, c]
            svc_dev = svc_matrix_build(self._to_device(flat),
                                       self._to_device(vals), sp, np_b)
            self.uploads_h2d_bytes += flat.nbytes + vals.nbytes
            self.uploads_svc["sparse"] += 1
        else:
            pad = np.ascontiguousarray(np.pad(svc, ((0, 0), (0, np_b - n))))
            svc_dev = self._to_device(pad)
            self.uploads_h2d_bytes += pad.nbytes
            self.uploads_svc["dense"] += 1
        state.append(svc_dev)
        self._state = tuple(state)
        self._meta = self._signature(p)
        self._pending = np.zeros(0, np.int64)
        self._stale = False
        self.uploads_full += 1

    def _off_tables(self, gp: int, np_b: int, w: int) -> tuple:
        """(penalty, extra, vol_topo) tensors standing for "off" at these
        dims, made once on the device and kept."""
        if self._off is None or self._off[0] != (gp, np_b, w):
            dev = self.device
            self._off = ((gp, np_b, w),
                         torch.zeros((gp, np_b), dtype=torch.bool,
                                     device=dev),
                         torch.ones((gp, np_b), dtype=torch.bool, device=dev),
                         torch.full((gp, 0, w), -1, dtype=torch.int32,
                                    device=dev))
        return self._off[1:]

    def needs_full_upload(self, p: EncodedProblem) -> bool:
        """Would scheduling `p` force a full state re-upload (stale carry,
        node remap, or bucket/vocab signature growth)? A deep pipeline
        drains first — the upload would be built from host arrays that
        have not folded the in-flight waves."""
        return bool(self._stale or self._state is None
                    or self.enc.last_remap
                    or self._meta != self._signature(p))

    @property
    def pending_rows(self) -> bool:
        """True when quantization-correction rows are queued for the next
        dispatch — a deep pipeline must drain before shipping them (the row
        SET would clobber the card's un-pulled in-scan folds)."""
        return bool(self._pending.size)

    # ------------------------------------------------------------------ API
    def invalidate(self):
        """Force a full re-upload next tick (apply fold skipped, external
        surgery on the encoder, ...)."""
        self._stale = True

    def schedule(self, p: EncodedProblem) -> np.ndarray:
        """Run one tick on the resident state; returns int32[G, N]."""
        return self.schedule_async(p).get()

    def schedule_async(self, p: EncodedProblem) -> PendingCounts:
        """Dispatch one tick and start the counts' copy to the host without
        blocking; `PendingCounts.get()` waits for it. A caller that commits
        the PREVIOUS wave between the two pays only what the copy has left
        (`ops/pipeline.py` orchestrates exactly that)."""
        enc = self.enc
        G, N = p.extra_mask.shape

        if self.needs_full_upload(p):
            self._upload_full(p)
            dirty = np.zeros(0, np.int64)
        else:
            dirty = np.union1d(self._pending, enc.last_dirty_rows) \
                .astype(np.int64)
            self._pending = np.zeros(0, np.int64)

        np_b, kp, plp, pvp, rp, sp = self._padded_dims(p)
        has_deltas = dirty.size > 0
        if has_deltas:
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

        # the builder-stamped flags replace O(G*N) scans (None = unknown)
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
        # binpack (K9) ignores the spread table, which ships all the same,
        # as the reference ships it
        strategy = 1 if getattr(p, "strategy", "spread") == "binpack" else 0

        # values the kernels index with, checked on the host: the tick
        # never waits on the card for a check. Sums that could wrap are
        # the steps' to flag; the flags ride the counts' copy
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
                if lmax:
                    if p.spread_rank.min() < 0 or p.spread_rank.max() >= N:
                        raise ValueError(f"spread_rank outside [0, {N})")
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

        # group-table cache: successive waves of the SAME services
        # re-encode identical constraint/platform/spread/... tables; only
        # n_tasks (and penalty, when failures decay) move. Two gates,
        # cheapest first: (1) source IDENTITY — the encoder re-emits
        # unchanged [., N]-sized tables as the same object (spread-table
        # cache; the placeholder singletons), an O(1) hit that skips the
        # padded rebuild and the memcmp; (2) value equality of the padded
        # copy. The kernels only read group tables, so a hit is safe.
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
            group_dev[slot] = self._to_device(h)
        self._gcache = list(zip(group_host, group_dev))
        self._gsrc = srcs
        self._gdims = dims
        self.uploads_group_tables += len(ship_slots)
        self.uploads_h2d_bytes += sum(a.nbytes for a in deltas) \
            + sum(a.nbytes for a in to_ship)

        if has_deltas:
            resident_delta_scatter(self._state,
                                   [self._to_device(a) for a in deltas])
        (ready, node_val, node_plat, node_plugins, port_used, avail_res,
         total0, svc_mat) = self._state
        pen_off, extra_on, vt_off = self._off_tables(
            gp, np_b, _PLACEHOLDER_VOLTOPO.shape[2])
        # padded groups (n_tasks 0) place and fold nothing: the fill runs
        # the real ones only, on row views of the padded tables
        (constraints, plat_req, req_plugins, n_tasks, svc_idx_d, need_res,
         max_replicas, penalty, has_ports, group_ports, spread_rank, extra,
         vol_topo) = (t[:G] for t in group_dev)
        pen_off, extra_on, vt_off = pen_off[:G], extra_on[:G], vt_off[:G]
        # the fill folds into the resident state in place
        counts, flags = schedule_core(
            ready, node_val, node_plat, node_plugins,
            extra if use_extra else extra_on,
            constraints, plat_req, req_plugins,
            vol_topo if use_voltopo else vt_off,
            n_tasks, svc_idx_d, need_res, max_replicas,
            penalty if use_penalty else pen_off,
            has_ports, group_ports, spread_rank,
            FillState(total0, svc_mat, avail_res, port_used), strategy)
        # pull form: dense [G, N] window vs sparse (idx, val), by bytes. k
        # bounds the nonzero count by the tick's total tasks, bucketed
        total = int(p.n_tasks.sum())
        k = _bucket(max(total, 1))
        dense_bytes = G * N * (2 if compact else 4)
        sparse_bytes = k * (4 + (2 if compact else 4))
        if k < G * N and sparse_bytes < dense_bytes:
            self.pulls["sparse"] += 1
            return PendingCounts(
                (*sparse_counts(counts, G, N, k, compact), flags), (G, N),
                on_refuse=self.invalidate)
        self.pulls["dense"] += 1
        return PendingCounts((counts_window(counts, G, N, compact), flags),
                             on_refuse=self.invalidate)

    def after_apply(self, p: EncodedProblem, counts: np.ndarray):
        """Called after the scheduler applied this tick's placements and
        the encoder folded them (`apply_counts`). Computes where the card's
        quantized in-kernel fold diverges from the host's raw-subtraction
        fold and queues those rows for upload."""
        enc = self.enc
        if self._stale or self._state is None:
            return
        if p.node_ids != enc._ids:
            self._stale = True
            return
        # the card carried: p.avail_res (pre-tick) - counts^T @ quantized
        # need. Compare the problem's column width only: a vocab-growth
        # encode may have widened the encoder arrays after this wave
        # dispatched; the new kind columns reach the card via the full
        # re-upload that growth forces, not via correction rows.
        r = p.avail_res.shape[1]
        if enc.avail_res.shape[1] < r:
            self._stale = True
            return
        dev_avail = p.avail_res.astype(np.int64) - \
            counts.astype(np.int64).T @ p.need_res.astype(np.int64)
        diff = (dev_avail != enc.avail_res[:, :r]).any(axis=1)
        self._pending = np.union1d(self._pending, np.flatnonzero(diff)) \
            .astype(np.int64)

    # ------------------------------------------------------------ debugging
    def pull_state(self) -> dict:
        """The resident state as numpy copies, keyed by STATE_FIELDS."""
        return {k: v.to("cpu", copy=True).numpy()
                for k, v in zip(STATE_FIELDS, self._state)}


def _pad1(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] == n:
        return a
    out = np.zeros(n, a.dtype)
    out[:a.shape[0]] = a
    return out
