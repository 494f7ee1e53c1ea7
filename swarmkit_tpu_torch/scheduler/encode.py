"""Dictionary-encoding of cluster state into dense arrays for the device
kernels.

The port's copy of the JAX package's encoder: same vocabularies, same
arrays, same `KERNEL_ARG_FIELDS` contract, host code in numpy.

The reference's scheduler walks Go maps and compares strings per (task, node)
pair (manager/scheduler/scheduler.go:694-921, filter.go). The device backend
instead interns every string host-side — constraint keys/values, platforms,
plugin names, host ports — into integer vocabularies, and ships dense int32
tables to the device. All O(G×N) work (constraint matching, platform/plugin
gating, spread water-fill) happens in the placement kernels
(`ops.placement.schedule_groups`); host work is O(nodes + tasks).

The encoder is INCREMENTAL: an `IncrementalEncoder` keeps its vocabularies
and dense per-node rows across ticks and re-encodes only nodes whose
`NodeInfo.fingerprint` changed (plus node-set adds/removes); the small
group-side tables are rebuilt per tick. Vocabulary direction makes the
cache sound: NODES intern their attribute values / plugins / ports /
platforms into grow-only vocabularies, and group constraints LOOK UP (a miss
encodes as -1, which can never equal a node's id ≥ 0) — so a constraint
value first seen at tick t never invalidates a node row encoded at tick
t-k. The one-shot `encode()` wrapper runs a fresh encoder over everything.

Quantization spec (part of this framework's scheduling semantics, applied to
BOTH backends so they stay bit-identical):
  * CPU  reservations → milli-cores, task needs rounded up, node capacity down;
  * memory            → 4 KiB pages, same rounding;
which guarantees the batched path never overcommits a node.

Host-only predicates that don't reduce to interned-int equality (node.ip
IP/CIDR math — reference constraint.go:127-146 — and unparseable constraint
sets) are folded into a per-group `extra_mask` correction column.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..api.types import normalize_arch
from . import constraint as constraint_mod
from .filters import PluginFilter, ReadyFilter
from .nodeinfo import NodeInfo

UNLIMITED = 1 << 30
OP_EQ = 0
OP_NEQ = 1

CPU_QUANTUM = 1_000_000      # nano-cpus per milli-core
MEM_QUANTUM = 4096           # bytes per page

# CSI volume/topology kernel rows: a row is one candidate-
# volume × accessible-topology alternative of one mount — (mount_idx,
# key_col, val_id, ...) over csi pseudo-key node columns. The static
# bounds cap the kernel's [G, VA, N] working set; groups past them take
# the host-side check_volumes_on_node fallback walk.
VOL_TOPO_SEGS = 4      # segment pairs per row: driver presence + ≤3 topo
VOL_TOPO_MOUNTS = 4    # distinct CSI mounts encodable per group
VOL_TOPO_MAX_ALT = 8   # total rows per group before host fallback


class Vocab:
    """String interner. id 0 is reserved for the empty string."""

    def __init__(self):
        self._ids: dict[str, int] = {"": 0}

    def id(self, s: str) -> int:
        return self._ids.setdefault(s, len(self._ids))

    def lookup(self, s: str) -> int:
        """-1 when unseen: an unseen constraint value can never equal a node
        value id, and -1 != every valid id keeps != semantics right."""
        return self._ids.get(s, -1)

    def __len__(self):
        return len(self._ids)


@dataclass
class TaskGroup:
    """One (service_id, spec_version) scheduling group — all tasks identical."""

    service_id: str
    spec_version: int
    tasks: list  # api.objects.Task, sorted by id
    # parallel id list (same string objects). Build it WHERE the tasks are
    # constructed/sorted (they are cache-hot there): the wave-commit walk
    # keys on ids, and reading N ids off cold task objects is the walk's
    # dominant miss chain. Lazily derived when absent (correct, just cold).
    ids: list | None = None

    @property
    def key(self) -> tuple[str, int]:
        return (self.service_id, self.spec_version)

    def task_ids(self) -> list:
        if self.ids is None or len(self.ids) != len(self.tasks):
            self.ids = [t.id for t in self.tasks]
        return self.ids

    @property
    def spec(self):
        return self.tasks[0].spec


@dataclass
class EncodedProblem:
    """Device-ready staging arrays (numpy, host)."""

    node_ids: list[str]
    group_keys: list[tuple[str, int]]
    service_ids: list[str]
    groups: list[TaskGroup] = field(repr=False, default_factory=list)
    # the NodeInfo objects in row order at encode time (a snapshot of the
    # encoder's row list). Commit paths index it directly instead of
    # rebuilding a node-id -> info map per wave — at 10k nodes that map
    # rebuild was a measurable slice of every steady wave. `infos_seq`
    # stamps the encoder's row-object generation: a commit may trust
    # row_infos ONLY while it equals the encoder's current infos_seq
    # (an O(1) check) — any node replacement/remap in between bumps it,
    # and the commit falls back to resolving live objects by id.
    row_infos: list = field(repr=False, default=None)
    infos_seq: int = -1

    # node side
    ready: np.ndarray = None          # bool[N]
    avail_res: np.ndarray = None      # int32[N, R]
    total0: np.ndarray = None         # int32[N]
    svc_count0: np.ndarray = None     # int32[S, N]
    node_val: np.ndarray = None       # int32[N, K] interned value per key col
    node_plat: np.ndarray = None      # int32[N, 2] (os_id, arch_id)
    node_plugins: np.ndarray = None   # bool[N, PL]
    port_used0: np.ndarray = None     # bool[N, PV]

    # group side
    n_tasks: np.ndarray = None        # int32[G]
    svc_idx: np.ndarray = None        # int32[G]
    need_res: np.ndarray = None       # int32[G, R]
    max_replicas: np.ndarray = None   # int32[G]; 0 == unlimited
    constraints: np.ndarray = None    # int32[G, C, 3] (key_col, op, val); col<0 pad
    plat_req: np.ndarray = None       # int32[G, P, 2]; (-2,-2) pad row; 0 wildcard
    req_plugins: np.ndarray = None    # bool[G, PL]
    has_ports: np.ndarray = None      # bool[G]
    group_ports: np.ndarray = None    # bool[G, PV]
    penalty: np.ndarray = None        # bool[G, N]
    extra_mask: np.ndarray = None     # bool[G, N] host-side corrections
    # spread preferences (nodeset.go tree): node's branch id per level —
    # contiguous ranks of the label-value PATH PREFIX, lexicographically
    # sorted, so children of one parent occupy a contiguous id range;
    # levels past a group's preference count repeat the last real level
    # (a self-parented pour is a no-op)
    spread_rank: np.ndarray = None    # int32[G, LMAX, N]; LMAX may be 0

    # device-resident path (ops.resident): group -> PERSISTENT service row
    # in the encoder's grow-only service matrix, and that matrix's current
    # row count. svc_idx/svc_count0 above use TICK-LOCAL rows instead.
    svc_idx_persistent: np.ndarray = None  # int32[G]
    n_svc_rows: int = 0
    # True when any group's service had no persistent row yet at encode
    # time (row numbers are hypothetical until a fold allocates them) —
    # a deep pipeline must not dispatch AHEAD of such a wave, because a
    # later wave's hypothetical numbering would clash with it
    has_hypo_rows: bool = False
    # cheap dispatch gates (ops/resident.py): at 100k–1M nodes the
    # `penalty.any()` / `extra_mask.all()` scans are O(G·N) per tick, so
    # builders that KNOW the answer stamp it here. None = unknown, the
    # consumer scans. Conservative values (nonzero=True / all=False when
    # actually clean) are SAFE — they only ship the real array instead of
    # the placeholder, never change results.
    penalty_nonzero: bool | None = None
    extra_mask_all: bool | None = None
    # strategy seam: which scoring kernel consumers dispatch —
    # "spread" (default), "binpack" (prefer-fullest, flat), or "topology"
    # (spread with the encoder-prepended topology level; kernels treat it
    # as spread). pad_buckets MUST copy it — it changes dispatch.
    strategy: str = "spread"
    # CSI volume/topology feasibility rows (ops/placement._vol_topo_ok):
    # int32[G, VA, 1 + 2*VOL_TOPO_SEGS] of (mount, k0, v0, ...), -1 pad;
    # VA == 0 when no group mounts CSI volumes (the leg compiles away)
    vol_topo: np.ndarray = None
    # O(1) dispatch gate like penalty_nonzero: True = some group has
    # vol-topo rows, False = provably none, None = unknown (consumer
    # checks the array shape)
    vol_topo_any: bool | None = None


_INT32_MAX = (1 << 31) - 1


# Canonical positional order of EncodedProblem arrays as consumed by
# ops.placement.schedule_groups — the ONE place the positional-arg contract
# lives; the cluster step and the state converters derive from it.
KERNEL_ARG_FIELDS = (
    "ready", "node_val", "node_plat", "node_plugins", "extra_mask",
    "constraints", "plat_req", "req_plugins", "avail_res", "total0",
    "svc_count0", "n_tasks", "svc_idx", "need_res", "max_replicas",
    "penalty", "has_ports", "group_ports", "port_used0", "spread_rank",
    "vol_topo",
)


def _empty_vol_topo(G: int) -> np.ndarray:
    return np.full((G, 0, 1 + 2 * VOL_TOPO_SEGS), -1, np.int32)


def kernel_args(p: "EncodedProblem") -> tuple:
    """The problem's arrays in schedule_groups' positional order (numpy).
    A hand-built problem may predate the vol_topo field (None): that is
    the empty table (no CSI mounts anywhere)."""
    out = []
    for f in KERNEL_ARG_FIELDS:
        v = getattr(p, f, None)
        if v is None and f == "vol_topo":
            v = _empty_vol_topo(p.extra_mask.shape[0])
        out.append(np.asarray(v))
    return tuple(out)


def _bucket(n: int, floor: int = 1) -> int:
    b = max(n, floor, 1)
    return 1 << (b - 1).bit_length()


def pad_buckets(p: "EncodedProblem") -> "EncodedProblem":
    """Pad every kernel dimension to its power-of-two bucket so the jitted
    program compiles once per bucket, not once per exact problem shape
    (SURVEY.md §7 'bucket-and-pad, pre-warm compile cache').

    Padding is semantics-free: phantom nodes are not ready (never eligible,
    zero capacity, zero totals — they contribute nothing to branch
    aggregates), phantom groups have zero tasks and an all-false extra_mask,
    and padded spread levels replicate each group's last real level (a
    self-parented pour is a no-op). Callers slice results back to the real
    [G, N] window."""
    G, N = p.extra_mask.shape
    S = p.svc_count0.shape[0]
    K = p.node_val.shape[1]
    PL = p.node_plugins.shape[1]
    PV = p.port_used0.shape[1]
    R = p.avail_res.shape[1]
    C = p.constraints.shape[1]
    P = p.plat_req.shape[1]
    LMAX = p.spread_rank.shape[1]
    vt = p.vol_topo if p.vol_topo is not None else _empty_vol_topo(G)
    VA = vt.shape[1]
    Gp, Np, Sp = _bucket(G), _bucket(N), _bucket(S)
    Kp, PLp, PVp, Rp = _bucket(K), _bucket(PL), _bucket(PV), _bucket(R)
    Lp = _bucket(LMAX) if LMAX else 0
    Vp = _bucket(VA) if VA else 0
    if (Gp, Np, Sp, Kp, PLp, PVp, Rp, Lp, Vp) == (
            G, N, S, K, PL, PV, R, LMAX, VA):
        if p.vol_topo is None:
            p.vol_topo = vt     # normalize for positional consumers
        return p

    def pad(a: np.ndarray, shape: tuple, fill=0) -> np.ndarray:
        out = np.full(shape, fill, a.dtype)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    q = EncodedProblem(node_ids=p.node_ids, group_keys=p.group_keys,
                       service_ids=p.service_ids, groups=p.groups,
                       row_infos=p.row_infos, infos_seq=p.infos_seq)
    q.strategy = p.strategy             # changes dispatch: must survive
    q.vol_topo_any = p.vol_topo_any     # pad rows are -1 (no mount): safe
    q.ready = pad(p.ready, (Np,), False)
    q.total0 = pad(p.total0, (Np,))
    q.avail_res = pad(p.avail_res, (Np, Rp))
    q.svc_count0 = pad(p.svc_count0, (Sp, Np))
    q.node_val = pad(p.node_val, (Np, Kp))
    q.node_plat = pad(p.node_plat, (Np, 2))
    q.node_plugins = pad(p.node_plugins, (Np, PLp), False)
    q.port_used0 = pad(p.port_used0, (Np, PVp), False)
    q.n_tasks = pad(p.n_tasks, (Gp,))
    q.svc_idx = pad(p.svc_idx, (Gp,))
    q.need_res = pad(p.need_res, (Gp, Rp))
    q.max_replicas = pad(p.max_replicas, (Gp,))
    q.constraints = pad(p.constraints, (Gp, C, 3), -1)
    q.plat_req = pad(p.plat_req, (Gp, P, 2), -2)
    q.req_plugins = pad(p.req_plugins, (Gp, PLp), False)
    q.has_ports = pad(p.has_ports, (Gp,), False)
    q.group_ports = pad(p.group_ports, (Gp, PVp), False)
    q.penalty = pad(p.penalty, (Gp, Np), False)
    q.extra_mask = pad(p.extra_mask, (Gp, Np), False)
    sr = np.zeros((Gp, Lp, Np), np.int32)
    if LMAX:
        sr[:G, :LMAX, :N] = p.spread_rank
        if Lp > LMAX:
            # replicate each group's deepest real level into padded levels
            sr[:G, LMAX:, :N] = p.spread_rank[:, LMAX - 1:LMAX, :]
    q.spread_rank = sr
    # phantom vol-topo rows are all -1: mount -1 belongs to no real
    # mount, so they never tighten any group's feasibility
    q.vol_topo = np.full((Gp, Vp, vt.shape[2]), -1, np.int32)
    if VA:
        q.vol_topo[:G, :VA] = vt
    return q


def quantize_need(res) -> tuple[int, int]:
    cpu = -(-res.nano_cpus // CPU_QUANTUM) if res.nano_cpus > 0 else 0
    mem = -(-res.memory_bytes // MEM_QUANTUM) if res.memory_bytes > 0 else 0
    return min(cpu, _INT32_MAX), min(mem, _INT32_MAX)


def quantize_avail(res) -> tuple[int, int]:
    cpu = max(res.nano_cpus // CPU_QUANTUM, 0)
    mem = max(res.memory_bytes // MEM_QUANTUM, 0)
    return min(cpu, _INT32_MAX), min(mem, _INT32_MAX)


def _canon_value(key_lower: str, value: str) -> str:
    """Comparable form of an attribute value: case-folded (the reference
    compares case-insensitively, constraint.go:84-104). node.ip never reaches
    here — IP/CIDR math stays host-side in extra_mask."""
    return value.lower()


_PREDEFINED_KEYS = {
    "node.id", "node.hostname", "node.role",
    "node.platform.os", "node.platform.arch",
}


def _canon_key(key: str) -> str | None:
    """Canonical vocab form of a constraint key: predefined keys case-fold
    whole; label keys case-fold only the prefix — label *names* stay
    case-sensitive (reference constraint.go:175 'label itself is case
    sensitive'). None == unknown key, which matches no node regardless of
    operator (constraint.go default case)."""
    lk = key.lower()
    if lk in _PREDEFINED_KEYS or lk == "node.ip":
        return lk
    for prefix in (constraint_mod.NODE_LABEL_PREFIX,
                   constraint_mod.ENGINE_LABEL_PREFIX):
        if lk.startswith(prefix) and len(key) > len(prefix):
            return prefix + key[len(prefix):]
    return None


def _node_attr_value(node, ck: str) -> str:
    _, cands = constraint_mod.node_attribute(node, ck)
    return cands[0] if cands else ""


# csi pseudo-keys (vol-topo kernel rows): node columns carrying
# per-driver presence and accessible-topology segments. `_canon_key`
# never emits a "csi." prefix (predefined keys + label prefixes only),
# so these can't collide with constraint key columns. Driver names with
# "/" would alias topo keys — CSI driver names are reverse-DNS, no "/".
def _csi_presence_key(driver: str) -> str:
    return "csi.node/" + driver


def _csi_topo_key(driver: str, seg: str) -> str:
    return "csi.topo/" + driver + "/" + seg


def _node_key_value(node, ck: str) -> str:
    """Comparable (vocab) value of node key column `ck`. csi.* pseudo-key
    values carry an '=' prefix so a node missing the driver/segment
    (empty string, vocab id 0) can never equal a real required value;
    topology segment values stay case-SENSITIVE (volumes.go compares
    exactly). Everything else is a constraint attribute, case-folded per
    `_canon_value`."""
    if ck.startswith("csi.node/"):
        driver = ck[len("csi.node/"):]
        desc = node.description
        if desc is None:
            return ""
        if (desc.csi_info or {}).get(driver) is not None \
                or driver in (desc.csi_plugins or ()):
            return "=1"
        return ""
    if ck.startswith("csi.topo/"):
        driver, _, seg = ck[len("csi.topo/"):].partition("/")
        desc = node.description
        ninfo = ((desc.csi_info or {}) if desc else {}).get(driver)
        if ninfo is None:
            return ""
        val = (ninfo.accessible_topology or {}).get(seg)
        return "" if val is None else "=" + val
    return _canon_value(ck, _node_attr_value(node, ck))


def task_csi_mounts(task) -> list:
    """The task's CSI volume mounts (the volume set's own helper)."""
    runtime = task.spec.runtime
    if runtime is None:
        return []
    return [m for m in runtime.mounts if m.type == "csi"]


def _node_label(node, kind: str, label: str) -> str:
    if kind == "node":
        labels = node.spec.annotations.labels or {}
    else:
        desc = node.description
        labels = (desc.engine_labels or {}) if desc else {}
    return labels.get(label, "")


class IncrementalEncoder:
    """Persistent encoder: node-side dense rows and all vocabularies survive
    across ticks; `encode()` re-encodes only dirty nodes (fingerprint delta,
    adds, removes) and rebuilds the O(G) group tables. Steady-state host cost
    per tick is O(dirty nodes + groups + N numpy copies), not O(N × K Python).

    ZERO-SCAN fast path (`tracked=True`): even with zero dirty
    rows, the fingerprint scan itself — sort the infos by id, compare
    the id list, read (created_seq, mutations) off every NodeInfo — is
    an O(N) Python pass per encode() plus another per nodes_clean(),
    and at 10k nodes it dominates the steady tick's host tail. In
    tracked mode the caller FEEDS an explicit dirty set instead:

      * `mark_replaced(info)` — the caller swapped in a new NodeInfo
        object for an existing node id (full string re-encode);
      * `mark_numeric(info)` — an in-place mutation (add/remove task,
        failure) on the same object (numeric columns only);
      * `mark_node_set_changed()` — a node was added or removed (next
        encode falls back to the full sort + fingerprint scan, which
        re-syncs rows and clears every mark);
      * `force_numeric_reencode` / `poison_all_numeric` mark their rows
        themselves, so the existing heal paths need no extra calls.

    A steady encode with no marks then touches NO NodeInfo at all and
    performs 0 fingerprint scans (`fp_scans` counts them — the op-count
    guard's counter); nodes_clean() degrades to a flag check. The
    contract cuts both ways: in tracked mode EVERY NodeInfo mutation
    between encodes must arrive via a mark or via the wave-commit path
    (whose restamp_counts keeps fingerprints reconciled) — an unmarked
    mutation is invisible until the next full scan. The production
    Scheduler routes all of its mutation sites through marks;
    tests/test_steady_fastpath.py fuzzes tracked-vs-scan parity.
    """

    def __init__(self, max_constraints: int = 8, max_platforms: int = 4,
                 tracked: bool = False, strategy: str = "spread",
                 topology: str | None = None):
        self.max_constraints = max_constraints
        self.max_platforms = max_platforms
        self.tracked = tracked
        # strategy seam: stamped onto every emitted problem.
        # "topology" is spread with the configured axis as the OUTERMOST
        # spread level of EVERY group — the existing prefix-rank tree and
        # _tree_water_fill handle it unchanged (and nesting stays sound:
        # prepending a level keeps one parent per child segment).
        self.strategy = strategy
        self._topo_pair: tuple[str, str] | None = None
        if strategy == "topology":
            d = topology or ""
            dl = d.lower()
            for prefix, kind in ((constraint_mod.NODE_LABEL_PREFIX, "node"),
                                 (constraint_mod.ENGINE_LABEL_PREFIX,
                                  "engine")):
                if dl.startswith(prefix) and len(d) > len(prefix):
                    self._topo_pair = (kind, d[len(prefix):])
                    break
            if self._topo_pair is None:
                raise ValueError(
                    "strategy='topology' needs a label topology axis, "
                    "e.g. topology='node.labels.zone'")
        elif strategy not in ("spread", "binpack"):
            raise ValueError(f"unknown placement strategy: {strategy!r}")
        # tracked-mode dirty feed: node id -> NodeInfo (the CURRENT
        # object — a replaced node's mark carries the replacement)
        self._mark_full: dict[str, NodeInfo] = {}
        self._mark_numeric: dict[str, NodeInfo] = {}
        self._mark_set_changed = True       # ids unknown until first sync
        self._mark_all_numeric = False
        # observability / op-count guard: O(N) fingerprint scans taken
        # (encode's sync and nodes_clean both count) and the seconds the
        # last encode spent in sort + scan (the tick.dirty_scan stage)
        self.fp_scans = 0
        self.last_scan_s = 0.0
        # row-object generation: bumped whenever any row's NodeInfo
        # object may have been swapped (remap, replaced-object sync,
        # mark_replaced) — the problem.row_infos currentness stamp
        self.infos_seq = 0
        # spread-table cache: steady ticks re-derive an IDENTICAL
        # [G, LMAX, N] rank table from unchanged label columns — at scale
        # that rebuild is the encode's largest allocation. Keyed by the
        # groups' spread specs + N + a label-column generation stamp
        # (bumped by any full re-encode/remap — numeric dirt never
        # touches labels); a hit re-emits the SAME array object, which the
        # resident group-table cache turns into an O(1) identity hit.
        self._spread_cache: tuple | None = None
        self._label_gen = 0
        # vol-topo table cache: mirrors _spread_cache — a
        # steady tick re-emits the SAME array object so the resident
        # group-table cache gets an O(1) identity hit. Keyed by the row
        # CONTENT (column ids + vocab value ids), so vocab growth or
        # usage churn rebuilds; the empty table is cached per G.
        self._voltopo_cache: tuple | None = None
        self._voltopo_empty: dict[int, np.ndarray] = {}

        self.key_cols: dict[str, int] = {}   # canonical constraint key -> col
        self.val_vocab = Vocab()
        self.plugin_vocab = Vocab()
        self.port_vocab = Vocab()
        self.os_vocab = Vocab()
        self.arch_vocab = Vocab()
        self.kinds: list[str] = []           # generic resource kinds, grow-only

        # node tables, rows sorted by node id (the canonical tie-break order)
        self._ids: list[str] = []
        self._idx: dict[str, int] = {}
        self._infos: list[NodeInfo] = []
        # fingerprints as parallel arrays (vectorized restamp in apply_counts)
        self._fp_seq = np.full(0, -1, np.int64)
        self._fp_mut = np.zeros(0, np.int64)
        self.ready = np.zeros(0, bool)
        self.total0 = np.zeros(0, np.int32)
        self.node_plat = np.zeros((0, 2), np.int32)
        self.node_val = np.zeros((0, 0), np.int32)
        self.avail_res = np.zeros((0, 2), np.int32)
        # raw (unquantized) cpu/mem mirrors: lets apply_counts subtract
        # reservations exactly the way NodeInfo.add_task does, then re-derive
        # the quantized columns vectorized
        self._raw_avail = np.zeros((0, 2), np.int64)
        self.node_plugins = np.zeros((0, 1), bool)
        self.port_used = np.zeros((0, 1), bool)
        # service activity counts as a matrix [services-ever-seen, N]
        self._svc_mat = np.zeros((0, 0), np.int32)
        self._svc_row: dict[str, int] = {}
        self._failure_ids: set[str] = set()
        self._label_cols: dict[tuple[str, str], np.ndarray] = {}  # object[N]

        self._rf = ReadyFilter()
        self.last_dirty = 0   # observability: rows re-encoded by last call
        self.last_full = 0    # ... of which took the full (string) path
        # device-resident sync (ops.resident): row indices re-encoded by
        # the last encode() and whether the node-id row mapping changed
        self.last_dirty_rows: np.ndarray = np.zeros(0, np.int64)
        self.last_remap = False
        # hot-path id caches: avoid per-row f-string + dict churn
        self._default_plug_ids = [self.plugin_vocab.id(f"{t}/{n}")
                                  for t, n in PluginFilter.DEFAULT_PLUGINS]
        self._plug_id: dict[tuple[str, str], int] = {}
        self._port_id: dict[tuple[str, int], int] = {}

    # ------------------------------------------------------------ node sync
    def _sync_nodes(self, infos: list[NodeInfo]) -> tuple[set[int], set[int]]:
        """Align cached rows with the (sorted) info list; returns
        (full_dirty, numeric_dirty) row index sets. A replaced NodeInfo
        (new created_seq — node spec/description may have changed) takes the
        full string path; in-place mutations (add/remove task, failures —
        same created_seq, bumped mutation counter) only touch the numeric
        columns: totals, resources, service counts, ports, failures.
        Removals compact rows."""
        new_ids = [i.node.id for i in infos]
        dirty: set[int] = set()
        self.last_remap = new_ids != self._ids
        if new_ids != self._ids:
            old_idx = self._idx
            keep_src: list[int] = []
            keep_dst: list[int] = []
            for d, nid in enumerate(new_ids):
                s = old_idx.get(nid)
                if s is None:
                    dirty.add(d)
                else:
                    keep_src.append(s)
                    keep_dst.append(d)
            n_new = len(new_ids)

            def remap(arr: np.ndarray, fill=0) -> np.ndarray:
                out = np.full((n_new,) + arr.shape[1:], fill, arr.dtype)
                if keep_src:
                    out[keep_dst] = arr[keep_src]
                return out

            self.ready = remap(self.ready, False)
            self.total0 = remap(self.total0)
            self.node_plat = remap(self.node_plat)
            self.node_val = remap(self.node_val)
            self.avail_res = remap(self.avail_res)
            self._raw_avail = remap(self._raw_avail)
            self.node_plugins = remap(self.node_plugins, False)
            self.port_used = remap(self.port_used, False)
            self._fp_seq = remap(self._fp_seq, -1)
            self._fp_mut = remap(self._fp_mut)
            svc_new = np.zeros((self._svc_mat.shape[0], n_new), np.int32)
            if keep_src:
                svc_new[:, keep_dst] = self._svc_mat[:, keep_src]
            self._svc_mat = svc_new
            for key in list(self._label_cols):
                out = np.full(n_new, "", object)
                if keep_src:
                    out[keep_dst] = self._label_cols[key][keep_src]
                self._label_cols[key] = out
            for nid in set(self._ids) - set(new_ids):
                self._failure_ids.discard(nid)
            self._ids = new_ids
            self._idx = {nid: i for i, nid in enumerate(new_ids)}
        self._infos = infos
        numeric: set[int] = set()
        fp_seq, fp_mut = self._fp_seq, self._fp_mut
        for i, info in enumerate(infos):
            if i in dirty:
                continue
            if fp_seq[i] != info.created_seq:
                dirty.add(i)         # replaced object: full re-encode
            elif fp_mut[i] != info.mutations:
                numeric.add(i)       # same object, counters moved
        if dirty or self.last_remap:
            # some row's OBJECT changed (replacement, add/remove): any
            # older problem's row_infos snapshot may now hold dead
            # objects — invalidate the commit-side reuse stamp
            self.infos_seq += 1
        return dirty, numeric

    # ------------------------------------------------- tracked dirty feed
    def mark_replaced(self, info: NodeInfo) -> None:
        """Tracked-mode feed: the caller replaced an EXISTING node's
        NodeInfo object wholesale (spec/description churn). The next
        encode re-runs the full string path for that row. No-op when
        untracked (the fingerprint scan catches it anyway)."""
        if self.tracked:
            self._mark_full[info.node.id] = info
            self.infos_seq += 1     # older row_infos now hold the dead
            #                         object: commit-side reuse falls back

    def mark_numeric(self, info: NodeInfo) -> None:
        """Tracked-mode feed: an in-place mutation (add/remove task,
        recorded failure) on the SAME NodeInfo object — only the numeric
        columns re-derive. No-op when untracked."""
        if self.tracked:
            self._mark_numeric[info.node.id] = info

    def mark_node_set_changed(self) -> None:
        """Tracked-mode feed: a node was added or removed. The next
        encode takes the full sort + fingerprint scan (which realigns
        rows and supersedes every pending mark)."""
        if self.tracked:
            self._mark_set_changed = True
            self.infos_seq += 1

    def _tracked_clean(self) -> bool:
        return not (self._mark_set_changed or self._mark_all_numeric
                    or self._mark_full or self._mark_numeric)

    def _clear_marks(self) -> None:
        self._mark_set_changed = False
        self._mark_all_numeric = False
        self._mark_full.clear()
        self._mark_numeric.clear()

    def _tracked_dirty(self, node_infos) -> tuple[set, set] | None:
        """Resolve the tracked marks to (full, numeric) row sets against
        the cached rows — the zero-scan path. Returns None when the fast
        path is not applicable (set changed, length drifted, or a marked
        id is unknown) and the caller must fall back to the full scan."""
        if self._mark_set_changed or len(node_infos) != len(self._ids):
            return None
        idx = self._idx
        dirty: set[int] = set()
        for nid, info in self._mark_full.items():
            i = idx.get(nid)
            if i is None:
                return None          # marked node unknown: re-sync
            self._infos[i] = info
            dirty.add(i)
        if self._mark_all_numeric:
            numeric = set(range(len(self._ids))) - dirty
        else:
            numeric = set()
            for nid, info in self._mark_numeric.items():
                i = idx.get(nid)
                if i is None:
                    return None
                if nid in self._mark_full:
                    # the row was ALSO replaced this batch: the full mark
                    # carries the latest object and its string re-encode
                    # subsumes the numeric one — a numeric mark recorded
                    # before the replacement holds the dead object, and
                    # trusting it below would resurrect stale rows
                    continue
                if self._infos[i] is not info:
                    # marked numeric but the object was swapped: treat as
                    # a replacement (defensive — string columns may have
                    # moved too)
                    self._infos[i] = info
                    self.infos_seq += 1
                    dirty.add(i)
                elif i not in dirty:
                    numeric.add(i)
        return dirty, numeric

    # --------------------------------------------------------- column growth
    def _ensure_key(self, ck: str) -> None:
        if ck in self.key_cols:
            return
        col = len(self.key_cols)
        self.key_cols[ck] = col
        n = len(self._ids)
        self.node_val = np.concatenate(
            [self.node_val, np.zeros((n, 1), np.int32)], axis=1)
        for i, info in enumerate(self._infos):
            self.node_val[i, col] = self.val_vocab.id(
                _node_key_value(info.node, ck))

    def _ensure_kind(self, kind: str) -> None:
        if kind in self.kinds:
            return
        self.kinds.append(kind)
        n = len(self._ids)
        col = np.zeros((n, 1), np.int32)
        for i, info in enumerate(self._infos):
            have = info.available_resources.generic.get(kind, 0)
            have += len(info.available_resources.named_generic.get(kind, ()))
            col[i, 0] = have
        self.avail_res = np.concatenate([self.avail_res, col], axis=1)

    def _grow_bool_cols(self) -> None:
        n = len(self._ids)
        for attr, vocab in (("node_plugins", self.plugin_vocab),
                            ("port_used", self.port_vocab)):
            arr = getattr(self, attr)
            want = max(len(vocab), 1)
            if arr.shape[1] < want:
                pad = np.zeros((n, want - arr.shape[1]), bool)
                setattr(self, attr, np.concatenate([arr, pad], axis=1))

    # ------------------------------------------------------------- node rows
    def _port_ids(self, ports) -> list[int]:
        cache = self._port_id
        out = []
        for key in ports:
            pid = cache.get(key)
            if pid is None:
                pid = self.port_vocab.id(f"{key[0]}:{key[1]}")
                cache[key] = pid
            out.append(pid)
        return out

    def _svc_row_for(self, service_id: str) -> int:
        row = self._svc_row.get(service_id)
        if row is None:
            row = len(self._svc_row)
            self._svc_row[service_id] = row
            if row >= self._svc_mat.shape[0]:
                grow = max(8, self._svc_mat.shape[0])
                self._svc_mat = np.concatenate(
                    [self._svc_mat,
                     np.zeros((grow, len(self._ids)), np.int32)], axis=0)
        return row

    def _encode_row_numeric(self, i: int, info: NodeInfo) -> None:
        """Refresh the columns in-place mutation can touch: totals, resources,
        service counts, host ports, failure set. String-valued columns
        (labels, platform, plugins, constraint attributes) only change when
        the NodeInfo object is replaced, which takes `_encode_row`."""
        nid = info.node.id
        self.total0[i] = info.active_tasks_count
        avail = info.available_resources
        self._raw_avail[i, 0] = avail.nano_cpus
        self._raw_avail[i, 1] = avail.memory_bytes
        row = self.avail_res[i]
        c = avail.nano_cpus // CPU_QUANTUM
        m = avail.memory_bytes // MEM_QUANTUM
        row[0] = c if 0 < c < _INT32_MAX else (0 if c <= 0 else _INT32_MAX)
        row[1] = m if 0 < m < _INT32_MAX else (0 if m <= 0 else _INT32_MAX)
        if self.kinds:
            generic = avail.generic
            named = avail.named_generic
            for j, kind in enumerate(self.kinds):
                row[2 + j] = (generic.get(kind, 0)
                              + len(named.get(kind, ())))

        if info.used_host_ports:
            port_ids = self._port_ids(info.used_host_ports)
            self._grow_bool_cols()
            self.port_used[i] = False
            self.port_used[i, port_ids] = True
        else:
            self.port_used[i] = False

        by_svc = info.active_tasks_count_by_service
        if by_svc or self._svc_mat.shape[0]:
            self._svc_mat[:, i] = 0
            for s, cnt in by_svc.items():
                if cnt:
                    # bind the row FIRST: _svc_row_for may replace _svc_mat
                    row_s = self._svc_row_for(s)
                    self._svc_mat[row_s, i] = cnt

        if info.recent_failures:
            self._failure_ids.add(nid)
        else:
            self._failure_ids.discard(nid)
        self._fp_seq[i] = info.created_seq
        self._fp_mut[i] = info.mutations

    def _encode_rows_numeric_bulk(self, rows: list[int], infos_all) -> None:
        """Vectorized `_encode_row_numeric` over many rows — the scalar
        columns (totals, raw + quantized cpu/mem, fingerprints) gather
        via np.fromiter and quantize in one vector pass; only the
        irregular pieces (generic kinds, host ports, per-service counts,
        the failure set) stay per-row Python. Bit-identical to the
        scalar path (tests/test_steady_fastpath.py pins it); the win is
        the crash-heal regime, where poison_all_numeric re-derives every
        row at once."""
        idx = np.asarray(rows, np.int64)
        infos = [infos_all[i] for i in rows]
        n = len(infos)
        self.total0[idx] = np.fromiter(
            (i.active_tasks_count for i in infos), np.int64, n
        ).astype(np.int32)
        cpus = np.fromiter(
            (i.available_resources.nano_cpus for i in infos), np.int64, n)
        mems = np.fromiter(
            (i.available_resources.memory_bytes for i in infos), np.int64, n)
        self._raw_avail[idx, 0] = cpus
        self._raw_avail[idx, 1] = mems
        self.avail_res[idx, 0] = np.clip(
            cpus // CPU_QUANTUM, 0, _INT32_MAX).astype(np.int32)
        self.avail_res[idx, 1] = np.clip(
            mems // MEM_QUANTUM, 0, _INT32_MAX).astype(np.int32)
        self.port_used[idx] = False
        if self._svc_mat.shape[0]:
            self._svc_mat[:, idx] = 0
        kinds = self.kinds
        failure_add = self._failure_ids.add
        failure_discard = self._failure_ids.discard
        for i, info in zip(rows, infos):
            avail = info.available_resources
            if kinds:
                row = self.avail_res[i]
                generic = avail.generic
                named = avail.named_generic
                for j, kind in enumerate(kinds):
                    row[2 + j] = (generic.get(kind, 0)
                                  + len(named.get(kind, ())))
            if info.used_host_ports:
                port_ids = self._port_ids(info.used_host_ports)
                self._grow_bool_cols()
                self.port_used[i, port_ids] = True
            for s, cnt in info.active_tasks_count_by_service.items():
                if cnt:
                    row_s = self._svc_row_for(s)
                    self._svc_mat[row_s, i] = cnt
            if info.recent_failures:
                failure_add(info.node.id)
            else:
                failure_discard(info.node.id)
        self._fp_seq[idx] = np.fromiter(
            (i.created_seq for i in infos), np.int64, n)
        self._fp_mut[idx] = np.fromiter(
            (i.mutations for i in infos), np.int64, n)

    def _encode_row(self, i: int, info: NodeInfo) -> None:
        node = info.node
        self.ready[i] = self._rf.check(info)
        for ck, col in self.key_cols.items():
            self.node_val[i, col] = self.val_vocab.id(
                _node_key_value(node, ck))
        desc = node.description
        if desc and desc.platform:
            self.node_plat[i, 0] = self.os_vocab.id(desc.platform.os.lower())
            self.node_plat[i, 1] = self.arch_vocab.id(
                normalize_arch(desc.platform.architecture))
        else:
            self.node_plat[i] = 0
        plug_ids = list(self._default_plug_ids)
        plugins = (desc.plugins if desc else None) or []
        if plugins:
            cache = self._plug_id
            for key in plugins:
                pid = cache.get(key)
                if pid is None:
                    pid = self.plugin_vocab.id(f"{key[0]}/{key[1]}")
                    cache[key] = pid
                plug_ids.append(pid)
        self._grow_bool_cols()
        self.node_plugins[i] = False
        self.node_plugins[i, plug_ids] = True

        for (kind, label), col in self._label_cols.items():
            col[i] = _node_label(node, kind, label)
        self._encode_row_numeric(i, info)

    def _label_col(self, kind: str, label: str) -> np.ndarray:
        col = self._label_cols.get((kind, label))
        if col is None:
            col = np.array(
                [_node_label(info.node, kind, label) for info in self._infos]
                or [], dtype=object)
            if col.shape != (len(self._infos),):
                col = np.full(len(self._infos), "", object)
            self._label_cols[(kind, label)] = col
        return col

    # ------------------------------------------------------ vol-topo tables
    def _voltopo_tables(self, groups, volume_set):
        """Resolve csi-mounting groups to kernel vol-topo rows.

        Returns (rows_per_group, fallback_groups, infeasible_groups). A
        row is (mount_idx, key_col, val_id, ...) over csi pseudo-key
        columns: the driver-presence pair plus the sorted topology
        segments of ONE (candidate volume, accessible-topology
        alternative). Node-independent candidate legs — availability,
        pending delete, sharing=="none" in use — filter host-side here
        (volumes.go isVolumeAvailableOnNode order); segment values LOOK
        UP (encoder contract: a value no node carries resolves to -1,
        matching nothing). What rows can't express sends the group to
        the check_volumes_on_node fallback walk: pinned single-scope
        volumes (usable only on its current nodes), > VOL_TOPO_MOUNTS
        mounts, a topology with > VOL_TOPO_SEGS-1 segments, or
        > VOL_TOPO_MAX_ALT total rows. A mount with NO usable candidate
        at all makes the group infeasible outright (extra_mask blank).
        """
        rows_per_group: list[list[tuple[int, ...]]] = [[] for _ in groups]
        fallback: set[int] = set()
        infeasible: set[int] = set()
        if volume_set is None:
            return rows_per_group, fallback, infeasible
        with volume_set._lock:
            for gi, g in enumerate(groups):
                mounts = task_csi_mounts(g.tasks[0])
                if not mounts:
                    continue
                if len(mounts) > VOL_TOPO_MOUNTS:
                    fallback.add(gi)
                    continue
                rows: list[tuple[int, ...]] = []
                bail = done = False
                for mi, m in enumerate(mounts):
                    m_rows: list[tuple[int, ...]] = []
                    for v in volume_set._candidates(m.source):
                        if v.spec.availability != "active" \
                                or v.pending_delete:
                            continue
                        u = volume_set.usage.get(v.id)
                        mode = v.spec.access_mode
                        if mode.sharing == "none" and u is not None \
                                and u.tasks:
                            continue
                        if mode.scope == "single" and u is not None \
                                and u.nodes:
                            bail = True     # pinned to node IDS, not a
                            break           # (driver, topology) predicate
                        driver = v.spec.driver
                        pname = _csi_presence_key(driver)
                        self._ensure_key(pname)
                        ppair = (self.key_cols[pname],
                                 self.val_vocab.lookup("=1"))
                        info = v.volume_info
                        topos = (info.accessible_topology
                                 if info is not None else [])
                        if not topos:
                            m_rows.append((mi,) + ppair)
                            continue
                        for topo in topos:
                            if len(topo) > VOL_TOPO_SEGS - 1:
                                bail = True
                                break
                            row = [mi, *ppair]
                            for k in sorted(topo):
                                kname = _csi_topo_key(driver, k)
                                self._ensure_key(kname)
                                row.append(self.key_cols[kname])
                                row.append(self.val_vocab.lookup(
                                    "=" + topo[k]))
                            m_rows.append(tuple(row))
                        if bail:
                            break
                    if bail:
                        break
                    if not m_rows:
                        # no usable candidate for this mount: no node can
                        # ever satisfy the group (check_volumes_on_node
                        # would answer False everywhere)
                        infeasible.add(gi)
                        done = True
                        break
                    rows.extend(m_rows)
                if bail or (not done and len(rows) > VOL_TOPO_MAX_ALT):
                    fallback.add(gi)
                elif not done:
                    rows_per_group[gi] = rows
        return rows_per_group, fallback, infeasible

    def _voltopo_emit(self, rows_per_group, G: int) -> np.ndarray:
        VA = max((len(r) for r in rows_per_group), default=0)
        if VA == 0:
            arr = self._voltopo_empty.get(G)
            if arr is None:
                arr = _empty_vol_topo(G)
                self._voltopo_empty[G] = arr
            return arr
        key = tuple(tuple(rs) for rs in rows_per_group)
        cached = self._voltopo_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        arr = np.full((G, VA, 1 + 2 * VOL_TOPO_SEGS), -1, np.int32)
        for gi, rs in enumerate(rows_per_group):
            for ri, row in enumerate(rs):
                arr[gi, ri, :len(row)] = row
        self._voltopo_cache = (key, arr)
        return arr

    # --------------------------------------------------------- placement fold
    def apply_counts(self, p: EncodedProblem, counts: np.ndarray) -> bool:
        """Fold a tick's own applied placements back into the cached rows —
        vectorized, no per-node Python — and restamp fingerprints so the next
        tick sees no dirty rows from placements the scheduler itself made.

        Contract: called immediately after the scheduler applied EXACTLY one
        `NodeInfo.add_task` per placed task of this tick (counts[g, n] tasks
        of group g onto node n), with no other NodeInfo mutations in between;
        `p` must be the problem this encoder emitted for the tick. add_task
        bumps `mutations` once per call, so the new fingerprint per node is
        (created_seq, mutations + placed_on_node) — anything else that moved
        the counters shows up as a mismatch next tick and re-encodes (safe).
        Returns False (caller should skip folding) when node sets diverged.

        Pipelined split (ops/pipeline.py): `fold_counts` is the array fold
        alone — everything the NEXT encode() needs — and `restamp_counts`
        is the fingerprint stamp, legal only once the add_task loop ran.
        Between the two calls the encoder arrays are ahead of the NodeInfo
        objects; `encode()` is safe in that window ONLY while no node row
        is dirty (`nodes_clean`), because a dirty row would re-encode from
        the not-yet-updated info and clobber the fold.
        """
        if not self.fold_counts(p, counts):
            return False
        self.restamp_counts(p, counts)
        return True

    def nodes_clean(self, infos) -> bool:
        """Read-only dirty check: True iff `encode(infos, …)` would find
        zero dirty rows and no remap. The pipelined tick driver uses
        this to decide whether encode() may run before the deferred
        add_task/restamp of the previous wave.

        Tracked mode answers from the mark flags alone — O(1), no
        NodeInfo reads, and therefore legal while a background heavy
        commit is still bumping mutation counters (the encode/commit
        overlap's gate). Untracked mode pays the full fingerprint scan.
        """
        if self.tracked:
            if not self._tracked_clean():
                return False
            infos = infos if hasattr(infos, "__len__") else list(infos)
            return len(infos) == len(self._ids)
        infos = sorted(infos, key=lambda i: i.node.id)
        if [i.node.id for i in infos] != self._ids:
            return False
        self.fp_scans += 1
        n = len(infos)
        seq = np.fromiter((i.created_seq for i in infos), np.int64, n)
        mut = np.fromiter((i.mutations for i in infos), np.int64, n)
        return bool(np.array_equal(seq, self._fp_seq)
                    and np.array_equal(mut, self._fp_mut))

    def force_numeric_reencode(self, rows: np.ndarray) -> None:
        """Poison `rows`' numeric fingerprints so the next encode()
        re-derives their numeric columns from the NodeInfo objects.

        The pipelined unclean-commit heal needs this: an optimistic
        fold_counts cannot be reverted row-wise, and a node whose decided
        placements ALL failed to commit never had its mutation counter
        bumped — its fingerprint still matches, so without poisoning the
        phantom reservations would persist and break oracle parity."""
        rows = np.asarray(rows, np.int64)
        if rows.size:
            self._fp_mut[rows] -= 1
            if self.tracked:
                # the zero-scan path never reads fingerprints: the heal
                # must also land in the mark feed
                for r in rows.tolist():
                    self._mark_numeric[self._ids[r]] = self._infos[r]

    def poison_all_numeric(self) -> None:
        """Crash-path heal: poison EVERY row's numeric fingerprint. The
        async commit worker can die before it even enters the job (so no
        wave was recorded for the targeted heal) — any row may then
        carry an optimistic fold no add_task ever backed."""
        self._fp_mut -= 1
        if self.tracked:
            self._mark_all_numeric = True

    def restamp_counts(self, p: EncodedProblem, counts: np.ndarray) -> bool:
        """Fingerprint half of apply_counts: stamp the add_task mutation
        bumps. Call exactly once per folded tick, after the add_task loop."""
        if p.node_ids != self._ids:
            return False
        placed = counts.astype(np.int64).sum(axis=0)
        if placed.any():
            self._fp_mut += placed
        return True

    def fold_counts(self, p: EncodedProblem, counts: np.ndarray) -> bool:
        """Array half of apply_counts: fold this tick's placements into the
        cached node tables (totals, resources, service counts, ports)
        WITHOUT touching fingerprints — see apply_counts docstring."""
        if p.node_ids != self._ids:
            return False
        counts64 = counts.astype(np.int64)
        placed = counts64.sum(axis=0)                     # [N]
        if not placed.any():
            return True
        G = counts.shape[0]
        self.total0 += placed.astype(np.int32)

        raw_need = np.zeros((G, 2), np.int64)
        for gi, g in enumerate(p.groups):
            res = g.spec.resources.reservations
            raw_need[gi, 0] = res.nano_cpus
            raw_need[gi, 1] = res.memory_bytes
        self._raw_avail -= counts64.T @ raw_need
        q = self._raw_avail[:, 0] // CPU_QUANTUM
        self.avail_res[:, 0] = np.clip(q, 0, _INT32_MAX)
        q = self._raw_avail[:, 1] // MEM_QUANTUM
        self.avail_res[:, 1] = np.clip(q, 0, _INT32_MAX)
        if self.kinds:
            gen_need = np.asarray(p.need_res[:, 2:], np.int64)
            if gen_need.any():
                # no clamp: mirrors _encode_row_numeric's unclamped read of
                # the generic pools so a later re-encode agrees bit-for-bit.
                # Slice to the problem's width: the kind vocab may have
                # grown (append-only) since this wave was encoded.
                k = 2 + gen_need.shape[1]
                used = counts64.T @ gen_need              # [N, kinds]
                self.avail_res[:, 2:k] = (
                    self.avail_res[:, 2:k].astype(np.int64) - used
                ).astype(np.int32)

        for gi, g in enumerate(p.groups):
            row = self._svc_row_for(g.service_id)
            self._svc_mat[row] += counts[gi].astype(np.int32)
            if p.has_ports[gi]:
                pids = np.flatnonzero(p.group_ports[gi])
                self.port_used[np.ix_(counts[gi] > 0, pids)] = True
        return True

    # ------------------------------------------------------------------ tick
    def encode(
        self,
        node_infos,
        groups: list[TaskGroup],
        now: float | None = None,
        volume_set=None,
    ) -> EncodedProblem:
        groups = sorted(groups, key=lambda g: g.key)
        t_scan = time.perf_counter()
        resolved = None
        if self.tracked:
            if not hasattr(node_infos, "__len__"):
                node_infos = list(node_infos)
            resolved = self._tracked_dirty(node_infos)
        if resolved is not None:
            # zero-scan fast path: dirty rows come from the mark feed;
            # the caller's list is only length-checked (same node set by
            # the tracked contract) — no sort, no id compare, no
            # per-node fingerprint reads
            dirty, numeric_dirty = resolved
            node_infos = self._infos
            self.last_remap = False
        else:
            node_infos = sorted(node_infos, key=lambda i: i.node.id)
            dirty, numeric_dirty = self._sync_nodes(node_infos)
            self.fp_scans += 1
        self._clear_marks()     # scan or mark resolution consumed them
        self.last_scan_s = time.perf_counter() - t_scan
        if dirty or self.last_remap:
            # full re-encodes rewrite label columns: spread ranks derived
            # from them may no longer match (numeric dirt never can)
            self._label_gen += 1
        N, G = len(node_infos), len(groups)

        # ------------------------------------------------ parse constraints
        parsed: list[list[constraint_mod.Constraint] | None] = []
        for g in groups:
            exprs = g.spec.placement.constraints
            if not exprs:
                parsed.append([])
                continue
            try:
                parsed.append(constraint_mod.parse(exprs))
            except constraint_mod.InvalidConstraint:
                parsed.append(None)  # unparseable → group matches nothing

        # ------------------------- group-side vocab / column growth (rare)
        for cs in parsed:
            for c in cs or []:
                ck = _canon_key(c.key)
                if ck is None or ck == "node.ip":
                    continue  # unknown → extra_mask; node.ip → host-side
                self._ensure_key(ck)
        for kind in sorted({k for g in groups
                            for k in g.spec.resources.reservations.generic}):
            self._ensure_kind(kind)

        # CSI vol-topo kernel rows: resolved EARLY — the csi
        # pseudo-key columns they intern must exist before the node_val
        # copy below picks up K
        vt_rows, vt_fallback, vt_infeasible = self._voltopo_tables(
            groups, volume_set)

        plugin_filter = PluginFilter()
        group_plugin_reqs: list[list[int]] = []
        for g in groups:
            reqs: list[int] = []
            if plugin_filter.set_task(g.tasks[0]):
                for drv in plugin_filter._volume_drivers:
                    reqs.append(self.plugin_vocab.id(f"Volume/{drv}"))
                for drv in plugin_filter._network_drivers:
                    reqs.append(self.plugin_vocab.id(f"Network/{drv}"))
                if plugin_filter._log_driver:
                    reqs.append(
                        self.plugin_vocab.id(f"Log/{plugin_filter._log_driver}"))
            group_plugin_reqs.append(reqs)

        # group ports must get columns even when no node uses them yet:
        # two groups publishing the same fresh port conflict through the
        # kernel's port_used updates within one tick
        group_port_lists: list[list[int]] = []
        for g in groups:
            ports = []
            endpoint = getattr(g.tasks[0], "endpoint", None)
            spec_ports = endpoint.ports if endpoint else []
            for pc in spec_ports:
                if pc.publish_mode == "host" and pc.published_port != 0:
                    ports.append(
                        self.port_vocab.id(f"{pc.protocol}:{pc.published_port}"))
            group_port_lists.append(ports)
        self._grow_bool_cols()

        # ------------------------------------------------- dirty node rows
        self.last_dirty = len(dirty) + len(numeric_dirty)
        self.last_full = len(dirty)
        self.last_dirty_rows = np.fromiter(
            sorted(dirty | numeric_dirty), np.int64,
            count=len(dirty | numeric_dirty))
        for i in sorted(dirty):
            self._encode_row(i, node_infos[i])
        if len(numeric_dirty) >= 64:
            # crash heals (poison_all_numeric) and mass churn re-derive
            # thousands of rows at once: the scalar per-row path pays
            # ~20 Python ops per row where a fromiter gather pays ~3
            self._encode_rows_numeric_bulk(sorted(numeric_dirty),
                                           node_infos)
        else:
            for i in sorted(numeric_dirty):
                self._encode_row_numeric(i, node_infos[i])

        # ------------------------------------------------------------ emit
        p = EncodedProblem(
            node_ids=list(self._ids),
            group_keys=[g.key for g in groups],
            service_ids=sorted({g.service_id for g in groups}),
            groups=groups,
            row_infos=list(self._infos),
            infos_seq=self.infos_seq,
        )
        p.strategy = self.strategy
        svc_row = {s: i for i, s in enumerate(p.service_ids)}
        S = max(len(p.service_ids), 1)

        # node side: copies — rows mutate in place on later ticks, the
        # emitted problem must stay self-consistent for its consumer
        p.ready = self.ready.copy()
        p.total0 = self.total0.copy()
        p.node_val = self.node_val.copy()
        p.node_plat = self.node_plat.copy()
        p.node_plugins = self.node_plugins.copy()
        p.port_used0 = self.port_used.copy()
        p.avail_res = self.avail_res.copy()
        p.svc_count0 = np.zeros((S, N), np.int32)
        for s, row in svc_row.items():
            mrow = self._svc_row.get(s)
            if mrow is not None:
                p.svc_count0[row] = self._svc_mat[mrow]

        # ------------------------------------------------ group-side tables
        K = max(len(self.key_cols), 1)
        if p.node_val.shape[1] < K:
            p.node_val = np.concatenate(
                [p.node_val, np.zeros((N, K - p.node_val.shape[1]), np.int32)],
                axis=1)
        R = 2 + len(self.kinds)
        PL = p.node_plugins.shape[1]
        PV = p.port_used0.shape[1]

        p.n_tasks = np.array([len(g.tasks) for g in groups] or [],
                             np.int32).reshape(G)
        p.svc_idx = np.array([svc_row[g.service_id] for g in groups] or [],
                             np.int32).reshape(G)
        # persistent service rows for the device-resident path: the device
        # carries the encoder's grow-only service matrix, so its kernel
        # indexes by persistent row, not the tick-local svc_idx. Groups
        # LOOK UP (the encoder contract) — a service with no row yet gets
        # a HYPOTHETICAL one: the row apply_counts will allocate if this
        # tick's placements land, numbered in group order exactly like
        # apply_counts' _svc_row_for loop, so device and host agree.
        # Until then the row holds zeros on both sides.
        hypo: dict[str, int] = {}
        rows = []
        for g in groups:
            r = self._svc_row.get(g.service_id)
            if r is None:
                r = hypo.get(g.service_id)
                if r is None:
                    r = len(self._svc_row) + len(hypo)
                    hypo[g.service_id] = r
            rows.append(r)
        p.svc_idx_persistent = np.array(rows or [], np.int32).reshape(G)
        p.n_svc_rows = len(self._svc_row) + len(hypo)
        p.has_hypo_rows = bool(hypo)
        p.need_res = np.zeros((G, R), np.int32)
        p.max_replicas = np.zeros(G, np.int32)
        C = self.max_constraints
        p.constraints = np.full((G, C, 3), -1, np.int32)
        p.plat_req = np.full((G, self.max_platforms, 2), -2, np.int32)
        p.req_plugins = np.zeros((G, PL), bool)
        p.has_ports = np.zeros(G, bool)
        p.group_ports = np.zeros((G, PV), bool)
        p.penalty = np.zeros((G, N), bool)
        p.extra_mask = np.ones((G, N), bool)
        # exact-or-conservative dispatch gates: True/False the moment a
        # write lands (ops/resident.py skips its O(G·N) scans on these)
        extra_all = True
        pen_any = False

        group_row = {g.key: i for i, g in enumerate(groups)}

        for gi, g in enumerate(groups):
            res = g.spec.resources.reservations
            cpu, mem = quantize_need(res)
            p.need_res[gi, 0], p.need_res[gi, 1] = cpu, mem
            for j, kind in enumerate(self.kinds):
                p.need_res[gi, 2 + j] = res.generic.get(kind, 0)
            p.max_replicas[gi] = g.spec.placement.max_replicas

            cs = parsed[gi]
            if cs is None:
                p.extra_mask[gi, :] = False
                extra_all = False
            else:
                ci = 0
                for c in cs:
                    ck = _canon_key(c.key)
                    if ck is None:
                        # unknown key matches no node, regardless of operator
                        # (reference constraint.go default case)
                        p.extra_mask[gi, :] = False
                        extra_all = False
                        continue
                    if ck == "node.ip":
                        extra_all = False       # conservative: may write
                        for n, info in enumerate(node_infos):
                            if not constraint_mod._match_ip(
                                    c, info.node.status.addr or ""):
                                p.extra_mask[gi, n] = False
                        continue
                    if ci >= C:
                        # overflow constraints evaluated host-side (rare)
                        extra_all = False       # conservative: may write
                        for n, info in enumerate(node_infos):
                            _, cands = constraint_mod.node_attribute(
                                info.node, ck)
                            if not c.match(*cands):
                                p.extra_mask[gi, n] = False
                        continue
                    p.constraints[gi, ci] = (
                        self.key_cols[ck],
                        OP_EQ if c.operator == constraint_mod.EQ else OP_NEQ,
                        self.val_vocab.lookup(_canon_value(ck, c.exp)),
                    )
                    ci += 1

            platforms = g.spec.placement.platforms
            for pi, plat in enumerate(platforms[:self.max_platforms]):
                wos = plat.os.lower()
                warch = (normalize_arch(plat.architecture)
                         if plat.architecture else "")
                p.plat_req[gi, pi, 0] = self.os_vocab.lookup(wos) if wos else 0
                p.plat_req[gi, pi, 1] = (self.arch_vocab.lookup(warch)
                                         if warch else 0)

            for pid in group_plugin_reqs[gi]:
                p.req_plugins[gi, pid] = True
            for pid in group_port_lists[gi]:
                p.group_ports[gi, pid] = True
            p.has_ports[gi] = bool(group_port_lists[gi])

        # ------------------------------------------------- spread preferences
        # (nodeset.go:50-124) resolve each group's spread descriptors to label
        # lookups; a non-label descriptor is skipped without consuming a
        # level, and a missing label buckets the node under "" (own branch)
        def _spread_labels(g: TaskGroup) -> list[tuple[str, str]]:
            out = []
            for pref in g.spec.placement.preferences:
                d = pref.spread_descriptor
                dl = d.lower()
                for prefix, kind in ((constraint_mod.NODE_LABEL_PREFIX, "node"),
                                     (constraint_mod.ENGINE_LABEL_PREFIX,
                                      "engine")):
                    if dl.startswith(prefix) and len(d) > len(prefix):
                        out.append((kind, d[len(prefix):]))
                        break
            return out

        group_spread = [_spread_labels(g) for g in groups]
        if self._topo_pair is not None:
            # topology strategy: the configured axis becomes
            # the OUTERMOST level of every group — prefix ranks stay
            # properly nested, and the tree kernel/oracle are unchanged
            group_spread = [[self._topo_pair] + s for s in group_spread]
        LMAX = max((len(s) for s in group_spread), default=0)
        skey = (tuple(tuple(s) for s in group_spread), N, LMAX,
                self._label_gen)
        cached = self._spread_cache
        if LMAX and cached is not None and cached[0] == skey:
            # steady tick, unchanged labels: re-emit the SAME array object
            # — the resident group-table cache gates on identity, so both
            # the O(G·L·N) rebuild and the device re-upload are skipped.
            # Consumers treat emitted spread tables as read-only.
            p.spread_rank = cached[1]
        else:
            p.spread_rank = np.zeros((G, LMAX, N), np.int32)
            if LMAX:
                # rank value paths per (group, level) in numpy over the
                # cached per-label value columns — host work O(N) per
                # distinct label
                for gi, spread in enumerate(group_spread):
                    if not spread:
                        continue
                    prefix = np.zeros(N, np.int64)
                    for li, (kind, label) in enumerate(spread):
                        vals = self._label_col(kind, label)
                        # ids ordered by value string => prefix ranks sort
                        # lexicographically level by level
                        _, col = np.unique(vals, return_inverse=True)
                        combo = prefix * (int(col.max(initial=0)) + 1) + col
                        # contiguous ranks preserving (prefix, value) order
                        _, ranks = np.unique(combo, return_inverse=True)
                        p.spread_rank[gi, li] = ranks.astype(np.int32)
                        prefix = ranks.astype(np.int64)
                    for li in range(len(spread), LMAX):
                        p.spread_rank[gi, li] = \
                            p.spread_rank[gi, len(spread) - 1]
                self._spread_cache = (skey, p.spread_rank)

        # penalties: only iterate nodes that actually recorded failures
        for nid in self._failure_ids:
            i = self._idx.get(nid)
            if i is None:
                continue
            info = node_infos[i]
            for fkey in list(info.recent_failures):
                gi = group_row.get(fkey)
                if gi is not None and info.penalized(fkey, now):
                    p.penalty[gi, i] = True
                    pen_any = True

        # CSI volume feasibility: the common shape — driver
        # presence + accessible-topology match — rides the kernel's
        # vol_topo rows (built above; ops/placement._vol_topo_ok). What
        # rows can't express (see _voltopo_tables) keeps the host-side
        # check_volumes_on_node extra_mask walk, still the oracle; a
        # mount with NO usable candidate blanks the group outright.
        for gi in vt_infeasible:
            p.extra_mask[gi, :] = False
            extra_all = False
        if vt_fallback:
            for gi in sorted(vt_fallback):
                probe = groups[gi].tasks[0]
                extra_all = False               # conservative: may write
                for n, info in enumerate(node_infos):
                    if p.extra_mask[gi, n] and \
                            not volume_set.check_volumes_on_node(info, probe):
                        p.extra_mask[gi, n] = False
        p.vol_topo = self._voltopo_emit(vt_rows, G)
        p.vol_topo_any = bool(p.vol_topo.shape[1])

        p.penalty_nonzero = pen_any
        p.extra_mask_all = extra_all
        return p


def encode(
    node_infos: list[NodeInfo],
    groups: list[TaskGroup],
    now: float | None = None,
    max_constraints: int = 8,
    max_platforms: int = 4,
    volume_set=None,
    strategy: str = "spread",
    topology: str | None = None,
) -> EncodedProblem:
    """One-shot encode: a fresh IncrementalEncoder over the full cluster."""
    enc = IncrementalEncoder(max_constraints=max_constraints,
                             max_platforms=max_platforms,
                             strategy=strategy, topology=topology)
    return enc.encode(node_infos, groups, now=now, volume_set=volume_set)


def fold_problem(p_next: EncodedProblem, p_prev: EncodedProblem,
                 counts_prev: np.ndarray) -> bool:
    """Fold a still-uncommitted earlier wave's placements into a LATER
    emitted problem, in the kernel's QUANTIZED domain.

    A depth-D tick pipeline (`ops/pipeline.py`) encodes wave k before the
    host has pulled/folded waves k-D+1..k-1, so p_next's node snapshot
    is stale by those waves — but the device kernel is NOT: its in-scan
    carry already folded them (quantized needs, exactly what the CPU
    oracle's sequential-group fold does). Applying that same fold to the
    emitted arrays makes the oracle fill and the slot materialization on
    p_next bit-match the kernel again:

        total0     += counts.sum(groups)
        avail_res  -= counts^T @ need_res        (quantized, unclamped —
                                                  mirrors the oracle's
                                                  in-fill subtraction)
        port_used0 |= group ports of placed nodes
        svc_count0 += counts, joined by SERVICE ID (tick-local rows
                      differ between problems)

    Group-side vocab GROWTH between the encodes (new generic kinds, new
    port ids — both append-only) is fine: the earlier wave's tables are
    prefix-compatible and fold into the leading columns. Returns False
    only when the node set changed — the caller must then drain to the
    serial order. Fingerprints and the encoder's own arrays are
    untouched: this mutates only the emitted problem's copies.
    """
    if (p_next.node_ids != p_prev.node_ids
            or p_next.avail_res.shape[1] < p_prev.need_res.shape[1]
            or p_next.port_used0.shape[1] < p_prev.group_ports.shape[1]):
        return False
    c = np.asarray(counts_prev, np.int64)
    placed = c.sum(axis=0)
    if not placed.any():
        return True
    p_next.total0 = (p_next.total0.astype(np.int64)
                     + placed).astype(np.int32)
    r_prev = p_prev.need_res.shape[1]
    p_next.avail_res[:, :r_prev] = (
        p_next.avail_res[:, :r_prev].astype(np.int64)
        - c.T @ p_prev.need_res.astype(np.int64)).astype(np.int32)
    for gi in np.flatnonzero(p_prev.has_ports):
        pids = np.flatnonzero(p_prev.group_ports[gi])
        if pids.size:
            p_next.port_used0[np.ix_(c[gi] > 0, pids)] = True

    acc: dict[str, np.ndarray] = {}
    for gj, g in enumerate(p_prev.groups):
        if c[gj].any():
            cur = acc.get(g.service_id)
            acc[g.service_id] = c[gj] if cur is None else cur + c[gj]
    if acc:
        next_row = {g.service_id: int(p_next.svc_idx[i])
                    for i, g in enumerate(p_next.groups)}
        for sid, vec in acc.items():
            r = next_row.get(sid)
            if r is not None:
                p_next.svc_count0[r] = (
                    p_next.svc_count0[r].astype(np.int64)
                    + vec).astype(np.int32)
    return True
