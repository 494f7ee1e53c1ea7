"""Raft log-replay fast path: batched quorum tally + commit-index advance
(the port of the JAX package's `ops/raft_replay.py`).

    tally[e]     = Σ_m ack[m, e]
    committed[e] = tally[e] >= quorum
    commit       = length of the True-prefix of committed

Raft's commit rule is prefix-monotone: an entry is committed only if every
earlier entry is, hence the prefix reduction. Each function runs its kernel
for CUDA tensors and its plain PyTorch version for CPU tensors; a tensor on
any other device raises. Results are int32, as in the reference.

  * `replay_commit` (K4, csrc/replay_commit.cu): the tally;
  * `unpack_acks` (K10, csrc/unpack_bits.cu): the cold bit-packed ack
    upload;
  * `frontier_advance_burst` (K11, csrc/frontier_advance.cu): B rounds of
    frontier ORs on the resident matrix, one commit index each, in one
    launch; `frontier_advance` is the burst with B = 1;
  * `match_index_commit` (K12, csrc/match_index_commit.cu): the
    leader-side rule, the quorum-th largest match index;
  * `replay_log_scan` (K13, csrc/replay_log_scan.cu): the streaming tally;
  * `sharded_replay_tally` (K22, csrc/sharded_replay_tally.cu): the tally
    over an ack matrix split into k shards on one card, managers split
    (under `sharded_replay_commit`) or log split (under the mesh's fused
    step, `parallel/mesh.py` `sharded_cluster_step`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import _kernels
from .bitpack import unpack_bits


def _quorum(quorum, dev):
    return torch.as_tensor(quorum, dtype=torch.int32, device=dev).reshape(1)


def _check_acks(acks) -> tuple[int, int]:
    if acks.dtype != torch.bool or acks.dim() != 2:
        raise TypeError(f"acks: expected bool[M, E], got {acks.dtype}"
                        f"{list(acks.shape)}")
    if not acks.is_contiguous():
        raise ValueError("acks: not contiguous")
    return acks.shape


# -------------------------------------------------------------- K4 replay
def replay_commit_plain(acks, quorum):
    """Plain PyTorch replay: (commit_index int32 scalar, committed bool[E])."""
    tally = acks.to(torch.int32).sum(dim=0, dtype=torch.int32)
    committed = tally >= quorum
    prefix = torch.cumprod(committed.to(torch.int32), dim=0)
    return prefix.sum(dtype=torch.int32), prefix.to(torch.bool)


def replay_commit(acks, quorum):
    """acks: bool[M, E] (manager × log entry, True = durably appended);
    quorum: an int or an int32 scalar tensor. Returns (commit_index int32
    scalar tensor, committed bool[E]); commit_index is the number of
    committed entries (0 == nothing committed)."""
    dev = acks.device
    if _kernels.route("replay", acks) == "plain":
        return replay_commit_plain(
            acks, torch.as_tensor(quorum, dtype=torch.int32))
    M, E = _check_acks(acks)
    q = _quorum(quorum, dev)
    commit = torch.full((1,), E, dtype=torch.int32, device=dev)
    committed = torch.empty(E, dtype=torch.bool, device=dev)
    if E == 0:
        return commit[0], committed
    rc = _kernels.lib("replay_commit").skt_replay_commit(
        acks.data_ptr(), q.data_ptr(), commit.data_ptr(),
        committed.data_ptr(), M, E, _kernels.stream_of(acks))
    _kernels.check(rc, "replay_commit")
    replay_commit.launches += 1
    return commit[0], committed


replay_commit.launches = 0


# ----------------------------------------------------------- K10 unpack
def unpack_acks(packed, n_entries: int):
    """Bit-packed ack upload -> the bool[M, E] ack matrix on packed's
    device: packed uint8[M, ceil(E/8)] (`bitpack.pack_bits` on the host)
    ships 8x fewer bytes than the matrix and unpacks there (K10)."""
    return unpack_bits(packed, n_entries)


# -------------------------------------------------- K11 frontier advance
def frontier_advance_burst_plain(acks, frontiers_b, quorum):
    """Plain PyTorch burst, the reference's scan round by round: (acks',
    commits int32[B])."""
    q = torch.as_tensor(quorum, dtype=torch.int32, device=acks.device)
    entry = torch.arange(acks.shape[1], dtype=torch.int32,
                         device=acks.device)[None, :]
    commits = torch.zeros(frontiers_b.shape[0], dtype=torch.int32,
                          device=acks.device)
    for b, fr in enumerate(frontiers_b):
        acks = acks | (entry < fr[:, None])
        commits[b] = replay_commit_plain(acks, q)[0]
    return acks, commits


def frontier_advance_burst(acks, frontiers_b, quorum):
    """A burst of frontier advances: round b ORs `arange(E) <
    frontiers_b[b, m]` into row m of the ack matrix and takes the commit
    index of the result. acks: bool[M, E] (left as it is); frontiers_b:
    int32[B, M] (numpy or a tensor, moved to acks' device). Returns (acks'
    bool[M, E], commits int32[B]), the plain version for CPU acks, kernel
    K11 (csrc/frontier_advance.cu, one launch a burst) for CUDA acks."""
    dev = acks.device
    route = _kernels.route("frontier advance", acks)
    fronts = torch.as_tensor(frontiers_b, dtype=torch.int32).to(dev)
    M, E = _check_acks(acks) if route == "kernel" else acks.shape
    if fronts.dim() != 2 or fronts.shape[1] != M:
        raise ValueError(f"frontiers_b: expected int32[B, {M}], got "
                         f"{list(fronts.shape)}")
    if route == "plain":
        return frontier_advance_burst_plain(acks, fronts, quorum)
    fronts = fronts.contiguous()
    B = fronts.shape[0]
    q = _quorum(quorum, dev)
    commits = torch.full((B,), E, dtype=torch.int32, device=dev)
    out = torch.empty_like(acks)
    if E == 0:
        return out, commits
    rc = _kernels.lib("frontier_advance").skt_frontier_advance_burst(
        acks.data_ptr(), fronts.data_ptr(), q.data_ptr(), commits.data_ptr(),
        out.data_ptr(), M, E, B, _kernels.stream_of(acks))
    _kernels.check(rc, "frontier_advance_burst")
    frontier_advance_burst.launches += 1
    return out, commits


frontier_advance_burst.launches = 0


def frontier_advance(acks, frontier, quorum):
    """One round of the frontier advance on the resident ack matrix: ORs
    `arange(E) < frontier[m]` into row m (frontier int32[M]) and returns
    (acks', commit int32 scalar). The burst with B = 1 (K11 on the card)."""
    fronts = torch.as_tensor(frontier, dtype=torch.int32).reshape(1, -1)
    acks, commits = frontier_advance_burst(acks, fronts, quorum)
    return acks, commits[0]


# ------------------------------------------------- K12 match-index commit
def match_index_commit_plain(match_index, quorum):
    """Plain PyTorch leader-side rule: the quorum-th largest match index,
    indexed as the reference's `sorted_desc[quorum - 1]` is."""
    M = match_index.shape[0]
    q = torch.as_tensor(quorum, dtype=torch.int64, device=match_index.device)
    i = q - 1
    i = torch.where(i < 0, i + M, i).clamp(0, M - 1)
    return torch.sort(match_index, descending=True).values[i]


INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def host_quorum(quorum):
    """The quorum of a K12 launch as a Python int, or None for a tensor on
    the card (which the kernel reads itself). Every host form (an int, a
    numpy integer, a CPU tensor of one element) converts as
    `torch.as_tensor(quorum, dtype=torch.int32)` does, and what that refuses
    (an int outside the int32 range) raises the same way."""
    if type(quorum) is int and INT32_MIN <= quorum <= INT32_MAX:
        return quorum
    if isinstance(quorum, torch.Tensor) and quorum.device.type != "cpu":
        return None
    return int(torch.as_tensor(quorum, dtype=torch.int32).reshape(1)[0])


@functools.cache
def _match_index_entries():
    """K12's C entries, resolved once: (quorum by value, quorum on the
    card)."""
    lib = _kernels.lib("match_index_commit")
    return lib.skt_match_index_commit_at, lib.skt_match_index_commit


def match_index_commit(match_index, quorum):
    """Commit index from per-manager match indices int32[M] (the
    leader-side rule: the quorum-th largest). The index follows the
    reference's `sorted_desc[quorum - 1]` on every quorum: a negative index
    wraps once, then it is clamped into [0, M - 1], so quorum 0 and quorum
    > M give the smallest value. Returns an int32 scalar tensor: the plain
    version for CPU tensors, kernel K12 (csrc/match_index_commit.cu) for
    CUDA tensors.

    The reference sorts descending as `-sort(-x)`, which misorders
    INT32_MIN (its negation wraps to itself); the port orders it as the
    smallest value. A match index lies in [0, 2^31 - 1], where the two
    agree."""
    if match_index.dtype != torch.int32 or match_index.dim() != 1:
        raise TypeError(f"match_index: expected int32[M], got "
                        f"{match_index.dtype}{list(match_index.shape)}")
    if match_index.shape[0] == 0:
        raise ValueError("match_index: no managers")
    dev = match_index.device
    if _kernels.route("match-index commit", match_index) == "plain":
        return match_index_commit_plain(match_index, quorum)
    mi = match_index.contiguous()
    M = mi.shape[0]
    out = mi.new_empty(())
    at, on_card = _match_index_entries()
    q = host_quorum(quorum)
    if q is None:       # read by the kernel: the host never waits on it
        rc = on_card(mi.data_ptr(), _quorum(quorum, dev).data_ptr(),
                     out.data_ptr(), M, _kernels.raw_stream(mi))
    else:
        rc = at(mi.data_ptr(), q, out.data_ptr(), M, _kernels.raw_stream(mi))
    _kernels.check(rc, "match_index_commit")
    match_index_commit.launches += 1
    return out


match_index_commit.launches = 0


# ---------------------------------------------------- K13 streaming scan
def replay_log_scan_plain(acks, quorum, chunk: int = 65536):
    """Plain PyTorch streaming replay, the reference's chunked scan: chunk
    columns at a time, carrying the 'prefix still unbroken' flag."""
    q = torch.as_tensor(quorum, dtype=torch.int32, device=acks.device)
    total = torch.zeros((), dtype=torch.int32, device=acks.device)
    alive = torch.ones((), dtype=torch.int32, device=acks.device)
    for c0 in range(0, acks.shape[1], chunk):
        tally = acks[:, c0:c0 + chunk].to(torch.int32).sum(
            dim=0, dtype=torch.int32)
        prefix = torch.cumprod((tally >= q).to(torch.int32), dim=0) * alive
        total += prefix.sum(dtype=torch.int32)
        alive = alive * prefix[-1]
    return total


def replay_log_scan(acks, quorum, chunk: int = 65536):
    """The commit index of `replay_commit` (an int32 scalar tensor), with
    peak scratch O(M x chunk): the tally streams chunk columns at a time,
    with no [E] tally and no committed mask. The plain version for CPU
    acks, kernel K13 (csrc/replay_log_scan.cu) for CUDA acks."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    dev = acks.device
    if _kernels.route("replay scan", acks) == "plain":
        return replay_log_scan_plain(acks, quorum, chunk)
    M, E = _check_acks(acks)
    q = _quorum(quorum, dev)
    commit = torch.full((1,), E, dtype=torch.int32, device=dev)
    if E == 0:
        return commit[0]
    rc = _kernels.lib("replay_log_scan").skt_replay_log_scan(
        acks.data_ptr(), q.data_ptr(), commit.data_ptr(), M, E, chunk,
        _kernels.stream_of(acks))
    _kernels.check(rc, "replay_log_scan")
    replay_log_scan.launches += 1
    return commit[0]


replay_log_scan.launches = 0


# ------------------------------------------------- K22 sharded tally
_LAYOUTS = {"managers": 0, "log": 1}


def _shard_holes(shards, q):
    """Each log shard's first entry short of quorum (its width if none)."""
    out = []
    for a in shards:
        short = torch.nonzero(a.to(torch.int32).sum(dim=0, dtype=torch.int32)
                              < q)
        out.append(int(short[0, 0]) if short.numel() else a.shape[1])
    return out


def sharded_replay_tally_plain(shards, quorum, layout: str = "managers"):
    """Plain PyTorch sharded tally. managers: (commit int32 scalar,
    committed bool[E]) from the shards' partial tallies summed in shard
    order; log: (commit, the shards' committed bool[Eb] each), the commit
    the least of b * Eb + shard b's first hole, k * Eb when no shard has
    one."""
    q = torch.as_tensor(quorum, dtype=torch.int32)
    dev = shards[0].device
    if layout == "managers":
        tally = shards[0].to(torch.int32).sum(dim=0, dtype=torch.int32)
        for a in shards[1:]:
            tally = tally + a.to(torch.int32).sum(dim=0, dtype=torch.int32)
        prefix = torch.cumprod((tally >= q).to(torch.int32), dim=0)
        return prefix.sum(dtype=torch.int32), prefix.to(torch.bool)
    Eb = shards[0].shape[1]
    commit = len(shards) * Eb
    for b, hole in enumerate(_shard_holes(shards, q)):
        if hole < Eb:
            commit = min(commit, b * Eb + hole)
    entry = torch.arange(Eb, dtype=torch.int64, device=dev)
    return (torch.tensor(commit, dtype=torch.int32, device=dev),
            [b * Eb + entry < commit for b in range(len(shards))])


def _check_shards(shards) -> tuple[int, int]:
    shapes = {tuple(a.shape) for a in shards}
    if len(shapes) != 1:
        raise ValueError(f"shards of different shapes: {sorted(shapes)}")
    for a in shards:
        _check_acks(a)
    Mb, Eb = shards[0].shape
    if len(shards) * max(Mb, Eb) >= 1 << 31:
        raise ValueError(f"{len(shards)} shards of {Mb} x {Eb}: the index "
                         "is int32")
    return Mb, Eb


def sharded_replay_tally(shards, quorum, layout: str = "managers"):
    """The quorum tally and commit index of an ack matrix split into k
    shards (bool tensors on one device). layout "managers": shard b holds
    M/k manager rows of all E entries; returns (commit int32 scalar,
    committed bool[E]). layout "log": shard b holds every manager's
    entries [b * Eb, (b + 1) * Eb); returns (commit, committed bool[Eb]
    per shard). The plain version for CPU shards, kernel K22
    (csrc/sharded_replay_tally.cu, three launches) for CUDA shards; shards
    on two devices raise."""
    shards = list(shards)
    if layout not in _LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}: 'managers' or 'log'")
    if not shards:
        raise ValueError("no shards")
    if _kernels.route("sharded replay", *shards) == "plain":
        return sharded_replay_tally_plain(shards, quorum, layout)
    Mb, Eb = _check_shards(shards)
    k = len(shards)
    dev = shards[0].device
    q = _quorum(quorum, dev)
    commit = torch.full((1,), Eb if layout == "managers" else k * Eb,
                        dtype=torch.int32, device=dev)
    if layout == "managers":
        committed = torch.empty(Eb, dtype=torch.bool, device=dev)
        outs = []
    else:
        committed = [torch.empty(Eb, dtype=torch.bool, device=dev)
                     for _ in range(k)]
        outs = committed
    if Eb == 0:
        return commit[0], committed
    table = _kernels.pointer_table(
        [[a.data_ptr() for a in shards] + [o.data_ptr() for o in outs]], dev)
    partial = torch.empty(k * Eb, dtype=torch.int32, device=dev)
    hole = torch.full((k,), Eb, dtype=torch.int32, device=dev)
    rc = _kernels.lib("sharded_replay_tally").skt_sharded_replay_tally(
        table.data_ptr(), q.data_ptr(), partial.data_ptr(), hole.data_ptr(),
        commit.data_ptr(),
        committed.data_ptr() if layout == "managers" else None,
        _LAYOUTS[layout], k, Mb, Eb, _kernels.stream_of(q))
    _kernels.check(rc, "sharded_replay_tally")
    sharded_replay_tally.launches += 1
    return commit[0], committed


sharded_replay_tally.launches = 0


def sharded_replay_commit(mesh, axis: str = "managers"):
    """The replay with each of the mesh's k shards holding M/k managers'
    ack rows: returns fn(acks, quorum) -> (commit int32 scalar, committed
    bool[E]), the shards' partial tallies summed across shards (K22,
    managers split). `acks`: bool[M, E], numpy or a tensor; M not
    divisible by k raises. The mesh's axis must be `axis`."""
    if mesh.axis != axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")

    def fn(acks, quorum):
        a = acks if isinstance(acks, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(acks))
        M = a.shape[0]
        if M % mesh.size:
            raise ValueError(f"{M} managers do not split into {mesh.size} "
                             "equal shards")
        shards = [s.contiguous().to(mesh.device)
                  for s in torch.split(a, M // mesh.size)]
        return sharded_replay_tally(shards, quorum, layout="managers")

    return fn
