"""Batched reconciliation: the global services' desired-vs-actual set diff
and the replicated services' slot census (the port of the JAX package's
`ops/reconcile.py`).

    has[s, n]      = any runnable task of service s on node n
    create[s, n]   = eligible[s, n] ∧ ¬has[s, n]     (node missing its task)
    shutdown[s, n] = ¬eligible[s, n] ∧ has[s, n]     (task must drain)

Eligibility itself is string/constraint work and stays on the host;
`orchestrator.global_.GlobalOrchestrator.bulk_reconcile` is the
store-integrated consumer, through `compute_diff`. Each device function
runs its kernel for CUDA tensors and its plain PyTorch version (`*_plain`)
for CPU tensors; a tensor on any other device raises. Like the reference's
functions they are pure: a function that updates the task table or the
count carry returns new tensors and leaves its inputs as they are.

  * `global_diff` (K14, csrc/global_diff.cu): the dense diff;
    `global_diff_update` is K14 with its slot-set prologue on a copy of
    the table; `global_diff_update_compact` adds K15;
  * `diff_compact` (K15, csrc/diff_compact.cu): a decision matrix as
    row-major index lists, `nonzero(size=cap, fill_value=-1)`, plus the
    full count;
  * `task_count_flat` (K16, csrc/task_count_flat.cu): the flat runnable
    count per (service, node), the O(churn) diff's carry;
  * `global_diff_churn_burst` (K17, csrc/churn_burst.cu): B O(churn)
    rounds in one launch; `global_diff_churn` is one round, with the
    touched pairs;
  * `unpack_eligibility` (K10, over `ops/bitpack.py`): the cold bit-packed
    eligibility upload;
  * `replica_slot_state` (K18, csrc/replica_slot_state.cu): the replicated
    orchestrator's slot census (three flat bool planes over S x M slots
    and the runnable-slot count of each service), dispatched from host
    arrays by `compute_slot_state`.

Integer rules kept from the reference: ids past the last node are clipped
to N - 1 in the dense diff and the count; the churn round's flat index is
`row * N + max(value, 0)`, so a value of N lands in the count of (row + 1,
0), its eligibility gather clamps to N - 1, its count gather to S * N - 1,
and an add past S * N is dropped. The reference's flat int32 indices wrap
silently from 2^31 on; the port raises ValueError there instead (S * N
for the count carry, the churn and the compact lists; row * N + value for
a churn value). Update triples name slots inside the table, unique within
a round (the reference's contract, which neither side checks for
uniqueness); the wrappers check them (in numpy for host arrays, on the
card for CUDA tensors) and raise on a row or column outside the table.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from . import _kernels

# below this S×N product the numpy diff wins (the device round trip costs
# more than the diff); the reference's threshold
DIFF_THRESHOLD = 1_000_000

_I32 = 1 << 31


def _check(t, name: str, dtype, ndim: int) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype \
            or t.dim() != ndim:
        got = f"{t.dtype}{list(t.shape)}" if isinstance(t, torch.Tensor) \
            else type(t).__name__
        raise TypeError(f"{name}: expected a {dtype} tensor of {ndim} "
                        f"dimensions, got {got}")


def _contiguous(t, name: str):
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t


def _flat_limit(S: int, N: int, what: str) -> None:
    if S * N >= _I32:
        raise ValueError(
            f"{what}: S * N = {S} * {N} >= 2^31; the reference's flat int32 "
            "index would wrap silently there")


def _check_pair(eligible, task_nodes) -> tuple[int, int, int]:
    _check(eligible, "eligible", torch.bool, 2)
    _check(task_nodes, "task_nodes", torch.int32, 2)
    if task_nodes.shape[0] != eligible.shape[0]:
        raise ValueError(f"task_nodes: {task_nodes.shape[0]} rows for "
                         f"{eligible.shape[0]} services")
    if task_nodes.device != eligible.device:
        raise ValueError(f"task_nodes on {task_nodes.device}, eligible on "
                         f"{eligible.device}")
    S, N = eligible.shape
    return S, N, task_nodes.shape[1]


def _triples(rows, cols, vals, S: int, T: int, ndim: int, N: int | None,
             dev):
    """The update triples as contiguous int32 tensors on `dev`, checked:
    equal shapes of `ndim` dimensions, rows in [0, S), cols in [0, T), and
    (for a churn round, N given) row * N + max(value, 0) below 2^31.
    Triples already on a CUDA `dev` are checked there, with one read of
    the verdict; any others are checked in numpy and uploaded in one
    copy."""
    xs = (rows, cols, vals)
    shapes = [list(x.shape) if hasattr(x, "shape") else list(np.shape(x))
              for x in xs]
    if len(shapes[0]) != ndim or shapes.count(shapes[0]) != 3:
        raise ValueError(f"update triples: expected three equal shapes of "
                         f"{ndim} dimensions, got {shapes[0]}, {shapes[1]}, "
                         f"{shapes[2]}")
    on_card = dev.type == "cuda" and all(
        isinstance(x, torch.Tensor) and x.device == dev for x in xs)
    if on_card:
        r, c, v = (x.to(torch.int32).contiguous() for x in xs)
    else:
        host = np.stack([x.cpu().numpy() if isinstance(x, torch.Tensor)
                         else np.asarray(x) for x in xs]).astype(np.int32)
        r, c, v = host
    if math.prod(shapes[0]):
        if on_card:
            flat = r.long() * (N or 0) + v.clamp(min=0)
            lo_r, hi_r, lo_c, hi_c, hi_f = torch.stack(
                [r.min().long(), r.max().long(), c.min().long(),
                 c.max().long(), flat.max()]).tolist()
        else:
            flat = r.astype(np.int64) * (N or 0) + np.maximum(v, 0)
            lo_r, hi_r, lo_c, hi_c, hi_f = (int(r.min()), int(r.max()),
                                            int(c.min()), int(c.max()),
                                            int(flat.max()))
        if lo_r < 0 or hi_r >= S:
            raise ValueError(f"update rows outside [0, {S})")
        if lo_c < 0 or hi_c >= T:
            raise ValueError(f"update columns outside [0, {T})")
        if N is not None and hi_f >= _I32:
            raise ValueError("a churn value's flat index row * N + value "
                             "reaches 2^31, where the reference's int32 "
                             "index wraps")
    if on_card:
        return r, c, v
    both = torch.from_numpy(host).to(dev)
    return both[0], both[1], both[2]


# ------------------------------------------------------------ K14 the diff
def _set_slots_plain(task_nodes, rows, cols, vals):
    tn = task_nodes.clone()
    tn[rows.long(), cols.long()] = vals
    return tn


def global_diff_plain(eligible, task_nodes):
    """Plain PyTorch diff: (create bool[S, N], shutdown bool[S, N])."""
    S, N = eligible.shape
    has = torch.zeros(S * N, dtype=torch.bool, device=eligible.device)
    if N:
        rows = torch.arange(S, device=eligible.device)[:, None] * N
        flat = (rows + task_nodes.clamp(0, N - 1))[task_nodes >= 0]
        has[flat] = True
    has = has.view(S, N)
    return eligible & ~has, ~eligible & has


def _diff_kernel(eligible, tn, upd=None):
    """K14 on CUDA tensors: the slot-set prologue (upd: int32 rows, cols,
    vals on the card) into tn in place, then the diff. Returns (create,
    shutdown)."""
    S, N = eligible.shape
    T = tn.shape[1]
    create = torch.empty((S, N), dtype=torch.bool, device=eligible.device)
    shutdown = torch.empty_like(create)
    U = 0 if upd is None else upd[0].numel()
    if S * N == 0 and U == 0:
        return create, shutdown
    r, c, v = upd if U else (None, None, None)
    ptr = (lambda t: None if t is None else t.data_ptr())
    rc = _kernels.lib("global_diff").skt_global_diff(
        eligible.data_ptr(), tn.data_ptr(), ptr(r), ptr(c), ptr(v),
        create.data_ptr(), shutdown.data_ptr(), S, N, T, U,
        _kernels.stream_of(eligible))
    _kernels.check(rc, "global_diff")
    global_diff.launches += 1
    return create, shutdown


def global_diff(eligible, task_nodes):
    """eligible: bool[S, N]; task_nodes: int32[S, T], for each service the
    node indices of its runnable tasks, padded with -1 (ids >= N count as
    node N - 1, as in the reference). Returns (create bool[S, N], shutdown
    bool[S, N]): the plain version for CPU tensors, kernel K14
    (csrc/global_diff.cu) for CUDA tensors."""
    _check_pair(eligible, task_nodes)
    if _kernels.route("global diff", eligible) == "plain":
        return global_diff_plain(eligible, task_nodes)
    return _diff_kernel(_contiguous(eligible, "eligible"),
                        _contiguous(task_nodes, "task_nodes"))


def global_diff_update(eligible, task_nodes, upd_rows, upd_cols, upd_vals):
    """Device-resident diff step: eligibility and the task→node table live
    on the device; a round uploads only the churned slots as (service row,
    slot column, new node) triples (host arrays) and recomputes the diff.
    Returns (task_nodes', create, shutdown); task_nodes' is a new tensor
    (the next round's carry), task_nodes is left as it is. K14 with its
    slot-set prologue on the card."""
    S, N, T = _check_pair(eligible, task_nodes)
    r, c, v = _triples(upd_rows, upd_cols, upd_vals, S, T, 1, None,
                       eligible.device)
    if _kernels.route("global diff", eligible) == "plain":
        tn = _set_slots_plain(task_nodes, r, c, v)
        return (tn, *global_diff_plain(eligible, tn))
    tn = _contiguous(task_nodes, "task_nodes").clone()
    return (tn, *_diff_kernel(_contiguous(eligible, "eligible"), tn,
                              (r, c, v)))


def global_diff_update_compact(eligible, task_nodes, upd_rows, upd_cols,
                               upd_vals, cap: int):
    """global_diff_update, but the decisions come back as compact index
    lists (K15) instead of dense [S, N] matrices. Returns (task_nodes',
    create_idx int32[cap, 2], shutdown_idx int32[cap, 2], n_create,
    n_shutdown); index rows past the real count are (-1, -1). A count
    above cap means the lists were cut, and the caller pulls dense."""
    S, N, _ = _check_pair(eligible, task_nodes)
    _flat_limit(S, N, "global_diff_update_compact")
    tn, create, shutdown = global_diff_update(eligible, task_nodes,
                                              upd_rows, upd_cols, upd_vals)
    c_idx, n_c = diff_compact(create, cap)
    s_idx, n_s = diff_compact(shutdown, cap)
    return tn, c_idx, s_idx, n_c, n_s


# ------------------------------------------------------ K15 the compaction
def diff_compact_plain(mask, cap: int):
    """Plain PyTorch compaction: (idx int32[cap, 2], count int32 scalar)."""
    S, N = mask.shape
    dev = mask.device
    flags = mask.reshape(-1).to(torch.int32)
    count = flags.sum(dtype=torch.int32)
    pos = torch.cumsum(flags, 0, dtype=torch.int32) - 1
    cell = torch.arange(S * N, dtype=torch.int32, device=dev)
    target = torch.where(mask.reshape(-1) & (pos < cap), pos.long(), cap)
    out = torch.full((cap + 1, 2), -1, dtype=torch.int32, device=dev)
    # every cell past the cut goes to the spare row `cap`, dropped below
    out[target] = torch.stack([cell // max(N, 1), cell % max(N, 1)], 1)
    return out[:cap], count


def diff_compact(mask, cap: int):
    """A bool[S, N] decision matrix as index lists: (idx int32[cap, 2] of
    the first `cap` set cells (s, n) in row-major order, rows past the
    count (-1, -1); count int32 scalar, the full number of set cells,
    which may exceed cap). The reference's `nonzero(size=cap,
    fill_value=-1)` and `sum`: the plain version for CPU tensors, kernel
    K15 (csrc/diff_compact.cu) for CUDA tensors."""
    _check(mask, "mask", torch.bool, 2)
    if cap < 0:
        raise ValueError(f"cap {cap} < 0")
    S, N = mask.shape
    _flat_limit(S, N, "diff_compact")
    if _kernels.route("diff compaction", mask) == "plain":
        return diff_compact_plain(mask, cap)
    mask = _contiguous(mask, "mask")
    dev = mask.device
    idx = torch.empty((cap, 2), dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    cells = S * N
    lib = _kernels.lib("diff_compact")
    n_tiles = -(-cells // lib.skt_diff_compact_tile())
    scratch = torch.empty(n_tiles + 1, dtype=torch.int32, device=dev)
    rc = lib.skt_diff_compact(mask.data_ptr(), idx.data_ptr(),
                              count.data_ptr(), scratch.data_ptr(), S, N,
                              cap, _kernels.stream_of(mask))
    _kernels.check(rc, "diff_compact")
    diff_compact.launches += 1
    return idx, count[0]


# -------------------------------------------------- K10 cold eligibility
def pack_eligibility(eligible) -> np.ndarray:
    """Host half of the bit-packed eligibility upload: bool[S, N] ->
    uint8[S, ceil(N/8)] (little bit order), 8x fewer bytes to ship."""
    from .bitpack import pack_bits

    return pack_bits(eligible)


def unpack_eligibility(packed, n_nodes: int):
    """uint8[S, ceil(N/8)] -> bool[S, N] on packed's device (K10)."""
    from .bitpack import unpack_bits

    return unpack_bits(packed, n_nodes)


# ------------------------------------------------------- K16 the counts
def task_count_flat_plain(task_nodes, n_nodes: int):
    """Plain PyTorch count: int32[S * n_nodes]."""
    S = task_nodes.shape[0]
    cnt = torch.zeros(S * n_nodes, dtype=torch.int32,
                      device=task_nodes.device)
    if S * n_nodes == 0:
        return cnt
    rows = torch.arange(S, device=task_nodes.device)[:, None] * n_nodes
    flat = (rows + task_nodes.clamp(0, n_nodes - 1)).reshape(-1)
    return cnt.index_add_(0, flat, (task_nodes >= 0).reshape(-1)
                          .to(torch.int32))


def task_count_flat(task_nodes, n_nodes: int):
    """cnt[s * n_nodes + n] = number of runnable tasks of service s on
    node n (ids >= n_nodes count on node n_nodes - 1; -1 pads count
    nowhere): the resident carry of the O(churn) diff. The plain version
    for CPU tensors, kernel K16 (csrc/task_count_flat.cu) for CUDA tensors.
    Raises ValueError at S * n_nodes >= 2^31."""
    _check(task_nodes, "task_nodes", torch.int32, 2)
    S, T = task_nodes.shape
    if n_nodes < 0:
        raise ValueError(f"n_nodes {n_nodes} < 0")
    _flat_limit(S, n_nodes, "task_count_flat")
    if _kernels.route("task count", task_nodes) == "plain":
        return task_count_flat_plain(task_nodes, n_nodes)
    tn = _contiguous(task_nodes, "task_nodes")
    cnt = torch.empty(S * n_nodes, dtype=torch.int32, device=tn.device)
    if S * n_nodes == 0:
        return cnt
    rc = _kernels.lib("task_count_flat").skt_task_count_flat(
        tn.data_ptr(), cnt.data_ptr(), S, T, n_nodes, _kernels.stream_of(tn))
    _kernels.check(rc, "task_count_flat")
    task_count_flat.launches += 1
    return cnt


# ---------------------------------------------------- K17 the churn burst
def _churn_round_plain(eligible, tn, cnt, rows, cols, vals):
    """One round of the reference's `_churn_step`, in place on tn and cnt:
    (pairs int64[2U, 2], create, shutdown, valid)."""
    S, N = eligible.shape
    SN = S * N
    r, c = rows.long(), cols.long()
    old = tn[r, c]
    tn[r, c] = vals
    old_v, new_v = old >= 0, vals >= 0
    oldc, newc = old.clamp(min=0).long(), vals.clamp(min=0).long()
    fo, fn = r * N + oldc, r * N + newc
    for f, keep, step in ((fo, old_v, -1), (fn, new_v, 1)):
        keep = keep & (f < SN)            # an add past S * N is dropped
        cnt.index_add_(0, f[keep], torch.full_like(f[keep], step,
                                                   dtype=torch.int32))
    pr = torch.cat([r, r])
    pn = torch.cat([oldc, newc])
    valid = torch.cat([old_v, new_v])
    elig_p = eligible[pr, pn.clamp(max=N - 1)]
    cnt_p = cnt[(pr * N + pn).clamp(max=SN - 1)]
    create = valid & elig_p & (cnt_p == 0)
    shutdown = valid & ~elig_p & (cnt_p > 0)
    return torch.stack([pr, pn], 1), create, shutdown, valid


def _codes(create, shutdown, valid):
    return (create.to(torch.uint8) | (shutdown.to(torch.uint8) << 1)
            | (valid.to(torch.uint8) << 2))


def global_diff_churn_burst_plain(eligible, task_nodes, cnt_flat, rows_b,
                                  cols_b, vals_b):
    """Plain PyTorch burst, the reference's scan round by round: (tn',
    cnt', codes uint8[B, 2U]); the inputs are left as they are."""
    tn, cnt = task_nodes.clone(), cnt_flat.clone()
    B, U = rows_b.shape
    codes = torch.zeros((B, 2 * U), dtype=torch.uint8,
                        device=eligible.device)
    for b in range(B):
        _, cre, shut, valid = _churn_round_plain(
            eligible, tn, cnt, rows_b[b], cols_b[b], vals_b[b])
        codes[b] = _codes(cre, shut, valid)
    return tn, cnt, codes


def _check_churn(eligible, task_nodes, cnt_flat) -> tuple[int, int, int]:
    S, N, T = _check_pair(eligible, task_nodes)
    _check(cnt_flat, "cnt_flat", torch.int32, 1)
    if cnt_flat.shape[0] != S * N or cnt_flat.device != eligible.device:
        raise ValueError(f"cnt_flat: expected int32[{S * N}] on "
                         f"{eligible.device}, got {list(cnt_flat.shape)} on "
                         f"{cnt_flat.device}")
    _flat_limit(S, N, "churn")
    if N == 0:
        raise ValueError("churn: no nodes")
    return S, N, T


def _churn_kernel(eligible, task_nodes, cnt_flat, r, c, v, pairs=None):
    """K17 on CUDA tensors: (tn', cnt', codes uint8[B, 2U]); with `pairs`
    (B = 1) also the touched pairs int32[2U, 2]."""
    S, N = eligible.shape
    T = task_nodes.shape[1]
    B, U = r.shape
    tn = _contiguous(task_nodes, "task_nodes").clone()
    cnt = _contiguous(cnt_flat, "cnt_flat").clone()
    codes = torch.empty((B, 2 * U), dtype=torch.uint8, device=tn.device)
    if B * U == 0:
        return tn, cnt, codes
    old = torch.empty(U, dtype=torch.int32, device=tn.device)
    rc = _kernels.lib("churn_burst").skt_churn_burst(
        _contiguous(eligible, "eligible").data_ptr(), tn.data_ptr(),
        cnt.data_ptr(), r.data_ptr(), c.data_ptr(), v.data_ptr(),
        old.data_ptr(), codes.data_ptr(),
        None if pairs is None else pairs.data_ptr(), S, N, T, U, B,
        _kernels.stream_of(tn))
    _kernels.check(rc, "churn_burst")
    global_diff_churn_burst.launches += 1
    return tn, cnt, codes


def global_diff_churn_burst(eligible, task_nodes, cnt_flat, rows_b, cols_b,
                            vals_b):
    """A debounced reconcile pass: B churn rounds ([B, U] triples each,
    host arrays) applied in one launch. Returns (task_nodes', cnt_flat',
    codes uint8[B, 2U]): per round, for the touched pair i (< U: the
    slot's OLD node; >= U: the NEW one), bit0 = create, bit1 = shutdown,
    bit2 = valid. task_nodes' and cnt_flat' are new tensors; the inputs
    are left as they are. The plain version for CPU tensors, kernel K17
    (csrc/churn_burst.cu, one launch a burst) for CUDA tensors."""
    S, N, T = _check_churn(eligible, task_nodes, cnt_flat)
    r, c, v = _triples(rows_b, cols_b, vals_b, S, T, 2, N, eligible.device)
    if _kernels.route("churn burst", eligible) == "plain":
        return global_diff_churn_burst_plain(eligible, task_nodes, cnt_flat,
                                             r, c, v)
    return _churn_kernel(eligible, task_nodes, cnt_flat, r, c, v)


def global_diff_churn_plain(eligible, task_nodes, cnt_flat, rows, cols,
                            vals):
    """Plain PyTorch round: (tn', cnt', pairs int32[2U, 2], create,
    shutdown, valid)."""
    tn, cnt = task_nodes.clone(), cnt_flat.clone()
    pairs, cre, shut, valid = _churn_round_plain(eligible, tn, cnt, rows,
                                                 cols, vals)
    return tn, cnt, pairs.to(torch.int32), cre, shut, valid


def global_diff_churn(eligible, task_nodes, cnt_flat, rows, cols, vals):
    """O(churn) incremental reconcile step. State on the device:
    eligibility, the task→node table and the flat count carry
    (`task_count_flat`). A round uploads churned slots as (service, slot,
    new node) triples, unique slots within the round, and returns the new
    carries plus the decisions at every touched (service, node) pair:

        tn', cnt', pairs int32[2U, 2], create[2U], shutdown[2U], valid[2U]

    (pair i < U is the slot's OLD node, i >= U the NEW one; an old or new
    value of -1 gives the pair (s, 0) with valid False). The burst with
    B = 1 (K17 on the card)."""
    S, N, T = _check_churn(eligible, task_nodes, cnt_flat)
    r, c, v = _triples(rows, cols, vals, S, T, 1, N, eligible.device)
    if _kernels.route("churn burst", eligible) == "plain":
        return global_diff_churn_plain(eligible, task_nodes, cnt_flat, r, c,
                                       v)
    U = r.shape[0]
    pairs = torch.empty((2 * U, 2), dtype=torch.int32, device=r.device)
    tn, cnt, codes = _churn_kernel(eligible, task_nodes, cnt_flat,
                                   r[None], c[None], v[None], pairs)
    codes = codes[0]
    return (tn, cnt, pairs, (codes & 1).bool(), (codes & 2).bool(),
            (codes & 4).bool())


# ------------------------------------------------- K18 the slot census
def replica_slot_state_plain(service_idx, slot, runnable, running,
                             n_services: int, n_slots: int):
    """Plain PyTorch census: (used, slot_runnable, slot_running) bool[S *
    M], runnable_slots int32[S]."""
    key = service_idx.long() * n_slots + slot.long()
    planes = []
    for pick in (None, runnable, running):
        plane = torch.zeros(n_services * n_slots, dtype=torch.bool,
                            device=service_idx.device)
        k = key if pick is None else key[pick]
        plane.index_put_((k,), torch.ones_like(k, dtype=torch.bool))
        planes.append(plane)
    rows = planes[1].view(n_services, n_slots).sum(1, dtype=torch.int32)
    return (*planes, rows)


def _census_check(service_idx, slot, runnable, running, n_services: int,
                  n_slots: int) -> None:
    """Refuse (ValueError) what the kernel does not take: a census of 2^31
    cells or more, where the reference's int32 key wraps, and inputs that
    are not four 1-D tensors of one length (int32, int32, bool, bool)."""
    if n_services < 0 or n_slots < 0:
        raise ValueError(f"census of {n_services} x {n_slots} slots")
    if n_services * n_slots >= _I32:
        raise ValueError(
            f"slot census: S * M = {n_services} * {n_slots} >= 2^31; the "
            "reference's flat int32 key would wrap silently there")
    want = (("service_idx", service_idx, torch.int32),
            ("slot", slot, torch.int32), ("runnable", runnable, torch.bool),
            ("running", running, torch.bool))
    for name, t, dtype in want:
        if not isinstance(t, torch.Tensor) or t.dtype != dtype \
                or t.dim() != 1 or t.shape[0] != service_idx.shape[0]:
            got = f"{t.dtype}{list(t.shape)}" \
                if isinstance(t, torch.Tensor) else type(t).__name__
            raise ValueError(f"{name}: expected a 1-D {dtype} tensor of "
                             f"{service_idx.shape[0]} tasks, got {got}")


def _census_ranges(lo_s, hi_s, lo_m, hi_m, n_services: int,
                   n_slots: int) -> None:
    if lo_s < 0 or hi_s >= n_services:
        raise ValueError(f"service indices outside [0, {n_services})")
    if lo_m < 0 or hi_m >= n_slots:
        raise ValueError(f"slots outside [0, {n_slots})")


def _slot_state_kernel(service_idx, slot, runnable, running,
                       n_services: int, n_slots: int):
    """K18 on CUDA tensors whose shapes and ranges are checked: (used,
    slot_runnable, slot_running, runnable_slots)."""
    dev = service_idx.device
    planes = [torch.empty(n_services * n_slots, dtype=torch.bool,
                          device=dev) for _ in range(3)]
    rows = torch.empty(n_services, dtype=torch.int32, device=dev)
    rc = _kernels.lib("replica_slot_state").skt_replica_slot_state(
        service_idx.data_ptr(), slot.data_ptr(), runnable.data_ptr(),
        running.data_ptr(), *(p.data_ptr() for p in planes),
        rows.data_ptr(), service_idx.shape[0], n_services, n_slots,
        _kernels.stream_of(service_idx))
    _kernels.check(rc, "replica_slot_state")
    replica_slot_state.launches += 1
    return (*planes, rows)


def replica_slot_state(service_idx, slot, runnable, running,
                       n_services: int, n_slots: int):
    """The slot census of S = n_services services over slots [0, M =
    n_slots): service_idx int32[T] in [0, S), slot int32[T] in [0, M),
    runnable/running bool[T]. Returns (used, slot_runnable, slot_running)
    as flat bool[S * M], keyed service_idx * M + slot, and runnable_slots
    int32[S], the row sums of slot_runnable. The plain version for CPU
    tensors, kernel K18 (csrc/replica_slot_state.cu) for CUDA tensors.
    Raises ValueError at S * M >= 2^31 (where the reference's key wraps),
    on an index outside its range (the reference's numpy mirror raises
    IndexError there, its jit drops it) and on a wrong dtype or rank."""
    _census_check(service_idx, slot, runnable, running, n_services, n_slots)
    route = _kernels.route("slot census", service_idx, slot, runnable,
                           running)
    if service_idx.shape[0]:
        lo_s, hi_s, lo_m, hi_m = torch.stack(
            [service_idx.min(), service_idx.max(), slot.min(),
             slot.max()]).tolist()
        _census_ranges(lo_s, hi_s, lo_m, hi_m, n_services, n_slots)
    if route == "plain":
        return replica_slot_state_plain(service_idx, slot, runnable, running,
                                        n_services, n_slots)
    return _slot_state_kernel(*(_contiguous(t, n) for t, n in (
        (service_idx, "service_idx"), (slot, "slot"), (runnable, "runnable"),
        (running, "running"))), n_services, n_slots)


global_diff.launches = 0
diff_compact.launches = 0
task_count_flat.launches = 0
global_diff_churn_burst.launches = 0
replica_slot_state.launches = 0


# ------------------------------------------------------------- host side
def global_diff_np(eligible, task_nodes):
    """numpy mirror of `global_diff` (small-scale path and parity oracle;
    a copy of the reference's, which indexes ids >= N out of range)."""
    S, N = eligible.shape
    has = np.zeros((S, N), bool)
    valid = task_nodes >= 0
    rows = np.broadcast_to(np.arange(S)[:, None], task_nodes.shape)[valid]
    has[rows, task_nodes[valid]] = True
    return eligible & ~has, ~eligible & has


def compute_diff(eligible, task_nodes, device=None):
    """Backend-selecting wrapper over host arrays: kernel K14 at or above
    DIFF_THRESHOLD cells (on `device`: None is the card, and raises without
    one; "cpu" runs the plain version), numpy below, as in the reference.
    Output is identical either way (both are exact set algebra)."""
    S, N = eligible.shape
    if S * N >= DIFF_THRESHOLD:
        dev = resolve_device(device)
        create, shutdown = global_diff(
            torch.from_numpy(np.ascontiguousarray(eligible, bool)).to(dev),
            torch.from_numpy(np.ascontiguousarray(task_nodes, np.int32))
            .to(dev))
        return create.cpu().numpy(), shutdown.cpu().numpy()
    return global_diff_np(np.asarray(eligible), np.asarray(task_nodes))


def replica_slot_state_np(service_idx, slot, runnable, running,
                          n_services: int, n_slots: int):
    """numpy mirror of `replica_slot_state` (the small-census path and the
    parity oracle; a copy of the reference's, with int64 keys)."""
    key = service_idx.astype(np.int64) * n_slots + slot
    flat = n_services * n_slots
    used = np.zeros(flat, bool)
    used[key] = True
    slot_runnable = np.zeros(flat, bool)
    np.maximum.at(slot_runnable, key, runnable)
    slot_running = np.zeros(flat, bool)
    np.maximum.at(slot_running, key, running)
    runnable_slots = slot_runnable.reshape(
        n_services, n_slots).sum(axis=1).astype(np.int32)
    return used, slot_runnable, slot_running, runnable_slots


def _census_upload(arrays, dev):
    """The census inputs (host arrays, checked) on `dev`."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def _census_download(out):
    """The census outputs as host numpy arrays."""
    return tuple(t.cpu().numpy() for t in out)


def compute_slot_state(service_idx, slot, runnable, running,
                       n_services: int, n_slots: int, device=None):
    """Backend-selecting census over host arrays, the reference's rule:
    kernel K18 where DIFF_THRESHOLD <= S * M < 2^31 (on `device`: None is
    the card, and raises without one; "cpu" runs the plain version), numpy
    below the threshold and again from 2^31 cells, where the kernel's int32
    key would wrap and the numpy mirror's int64 keys stay exact. Both give
    the same answer. Service indices outside [0, S) and slots outside
    [0, M) raise ValueError on every branch. Returns numpy arrays."""
    service_idx, slot = np.asarray(service_idx), np.asarray(slot)
    if service_idx.size:
        _census_ranges(int(service_idx.min()), int(service_idx.max()),
                       int(slot.min()), int(slot.max()), n_services, n_slots)
    sidx, sl = service_idx.astype(np.int32), slot.astype(np.int32)
    runnable = np.asarray(runnable, bool)
    running = np.asarray(running, bool)
    flat = n_services * n_slots
    if DIFF_THRESHOLD <= flat < _I32:
        ins = _census_upload((sidx, sl, runnable, running),
                             resolve_device(device))
        return _census_download(replica_slot_state(*ins, n_services,
                                                   n_slots))
    return replica_slot_state_np(sidx, sl, runnable, running, n_services,
                                 n_slots)
