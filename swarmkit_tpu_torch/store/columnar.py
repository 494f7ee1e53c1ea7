"""Columnar mirror of the hot task table .

BENCH_r05 put the ceiling at the Python-object store: at 1M tasks the
tick is 21x the oracle but e2e only 6x, because every wave write-back
pays two tree copies plus full re-index per task. This module keeps the
scheduler-hot half of every Task as dense numpy columns — state /
desired-state / version / node-idx / service-idx / slot, keyed by an
interned task-id vocabulary that mirrors `IncrementalEncoder`'s node
vocab (insert on first sight, rows recycled through a free list on
delete) — so bulk wave write-back and hot queries become array ops.

Contract (docs/store.md): the OBJECT table remains the replicated
source of record; the columns are DERIVED TRUTH kept in lockstep by the
commit path (`MemoryStore._commit` feeds every committed task action
through `apply_actions`). The one legal divergence window is a LAZY
wave (`MemoryStore.assign_wave(lazy=True)` on a watcher-free plain
store): columns advance first and the object views are materialized
only when the API surface asks for a task the columns can't answer —
`MemoryStore._heal_stale_tasks` owns that materialization. Nothing
outside store/columnar.py, store/memory.py, allocator/batched.py and
ops/alloc.py may write these arrays (lint rule `columnar-mutate`).

The port's copy of the JAX package's `store/columnar.py`.
"""
from __future__ import annotations

from collections import Counter

import numpy as np

from ..api.types import TaskState


class IdVocab:
    """String interner with reverse lookup. id 0 is reserved for the
    empty string (an unassigned node / service-less task interns to 0),
    mirroring the encoder Vocab convention."""

    def __init__(self):
        self.names: list[str] = [""]
        self._ids: dict[str, int] = {"": 0}

    def intern(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self.names)
            self._ids[s] = i
            self.names.append(s)
        return i

    def lookup(self, s: str) -> int:
        """-1 when unseen (groups LOOK UP, writers INSERT)."""
        return self._ids.get(s, -1)

    def name(self, i: int) -> str:
        return self.names[i]

    def __len__(self):
        return len(self.names)


_GROW = 1024
COLUMNS = ("state", "desired", "version", "node_idx", "service_idx", "slot",
           "spec_version")

# version tag of the optional dense-column snapshot section:
# adopt() refuses anything else and the restore path falls back to
# rebuild(), so old snapshots (no section) and future formats both load
COLUMNAR_SECTION_VERSION = 1


def _enc(arr: np.ndarray) -> dict:
    """Codec-safe dense array: dtype string + raw bytes (the rpc codec
    has no numpy handler, and raw bytes round-trip cheaper anyway)."""
    return {"d": arr.dtype.str, "b": arr.tobytes()}


def _dec(obj, want_dtype, want_len: int):
    """Decode an _enc payload; None unless it is exactly the dtype and
    length the adopting mirror requires (adopt() treats None as a
    malformed section and falls back to rebuild)."""
    if not isinstance(obj, dict) or "d" not in obj or "b" not in obj:
        return None
    try:
        arr = np.frombuffer(obj["b"], dtype=np.dtype(obj["d"]))
    except (TypeError, ValueError):
        return None
    if arr.dtype != np.dtype(want_dtype) or arr.shape[0] != want_len:
        return None
    return arr.copy()  # frombuffer is read-only; columns must be writable


def _revocab(names) -> "IdVocab | None":
    """Rebuild an IdVocab from its serialized name list (id 0 must be
    the reserved empty string; duplicates would corrupt lookups)."""
    if not isinstance(names, list) or not names or names[0] != "":
        return None
    v = IdVocab()
    for s in names[1:]:
        v.intern(s)
    if len(v) != len(names):
        return None  # duplicate names collapsed: section is corrupt
    return v


def _grow_columns(owner, cols, need: int) -> None:
    """Shared capacity growth for every column mirror: double (or step
    by _GROW) until `need` rows fit, zero-filling the tail. One policy
    for ColumnarTasks and both hot sub-mirrors — change it here only."""
    cap = getattr(owner, cols[0]).shape[0]
    if need <= cap:
        return
    new_cap = cap
    while new_cap < need:
        new_cap = max(new_cap * 2, new_cap + _GROW)
    for name in cols:
        arr = getattr(owner, name)
        grown = np.zeros(new_cap, arr.dtype)
        grown[:cap] = arr
        setattr(owner, name, grown)


class ColumnarServices:
    """Hot-column mirror of the SERVICE table: replicas /
    spec-version / replicated-mode / pending-delete, indexed by the
    SHARED service IdVocab of the task columns — `service_idx` values in
    the task table are directly usable as row indices here. Row 0 (the
    reserved empty id) is never valid. Like the task columns these are
    DERIVED TRUTH kept in lockstep by `MemoryStore._commit`; the batched
    orchestrator reads them so a steady reconcile pass over 100k
    services touches zero service objects."""

    def __init__(self, vocab: IdVocab, cap: int = _GROW):
        self.vocab = vocab
        cap = max(cap, len(vocab), 1)
        self.replicas = np.zeros(cap, np.int64)
        self.spec_version = np.zeros(cap, np.int64)
        self.replicated = np.zeros(cap, bool)
        self.pending_delete = np.zeros(cap, bool)
        # non-terminal update status (updating / rollback_started): the
        # reconciler must keep kicking the update pass until it writes
        # a terminal status, even when no slot is dirty any more (the
        # restart supervisor may converge the slots on its own)
        self.in_update = np.zeros(cap, bool)
        self.valid = np.zeros(cap, bool)

    _COLS = ("replicas", "spec_version", "replicated", "pending_delete",
             "in_update", "valid")

    def upsert(self, service) -> int:
        from ..api.types import ServiceMode

        row = self.vocab.intern(service.id)
        _grow_columns(self, self._COLS, row + 1)
        self.replicas[row] = int(service.spec.replicas)
        self.spec_version[row] = (service.spec_version.index
                                  if service.spec_version is not None else -1)
        self.replicated[row] = service.spec.mode == ServiceMode.REPLICATED
        self.pending_delete[row] = bool(service.pending_delete)
        self.in_update[row] = (service.update_status or {}).get(
            "state") in ("updating", "rollback_started")
        self.valid[row] = True
        return row

    def delete(self, service_id: str) -> None:
        row = self.vocab.lookup(service_id)
        if row > 0 and row < self.valid.shape[0]:
            self.valid[row] = False

    def row_of(self, service_id: str) -> int:
        row = self.vocab.lookup(service_id)
        if row <= 0 or row >= self.valid.shape[0] or not self.valid[row]:
            return -1
        return row


class ColumnarNodes:
    """Hot-column mirror of the NODE table: status state / availability,
    indexed by the shared node IdVocab (task `node_idx` values are row
    indices). The batched orchestrator's node-down victim scan reads
    these instead of walking node objects."""

    def __init__(self, vocab: IdVocab, cap: int = _GROW):
        self.vocab = vocab
        cap = max(cap, len(vocab), 1)
        self.state = np.zeros(cap, np.int8)
        self.availability = np.zeros(cap, np.int8)
        self.valid = np.zeros(cap, bool)

    _COLS = ("state", "availability", "valid")

    def upsert(self, node) -> int:
        row = self.vocab.intern(node.id)
        _grow_columns(self, self._COLS, row + 1)
        self.state[row] = int(node.status.state)
        self.availability[row] = int(node.spec.availability)
        self.valid[row] = True
        return row

    def delete(self, node_id: str) -> None:
        row = self.vocab.lookup(node_id)
        if row > 0 and row < self.valid.shape[0]:
            self.valid[row] = False


class ColumnarDeps:
    """Hot-column mirror of a dependency table (secrets or configs):
    version / valid over the table's own IdVocab. Unlike task
    rows, dep rows are NEVER recycled — the vocab only grows — so a row
    index captured by a consumer (the dispatcher's per-session known
    columns) stays bound to the same object id forever, and a deleted-
    then-recreated dep re-lands on its old row with a strictly newer
    version. Same derived-truth rules as the task columns: the commit
    path (`MemoryStore._commit`) is the only steady writer."""

    def __init__(self, cap: int = _GROW):
        self.vocab = IdVocab()
        cap = max(cap, 1)
        self.version = np.zeros(cap, np.int64)
        self.valid = np.zeros(cap, bool)

    _COLS = ("version", "valid")

    def upsert(self, obj) -> int:
        row = self.vocab.intern(obj.id)
        _grow_columns(self, self._COLS, row + 1)
        self.version[row] = obj.meta.version.index
        self.valid[row] = True
        return row

    def delete(self, obj_id: str) -> None:
        row = self.vocab.lookup(obj_id)
        if row > 0 and row < self.valid.shape[0]:
            self.valid[row] = False

    def row_of(self, obj_id: str) -> int:
        """Live row index, -1 when unseen or deleted."""
        row = self.vocab.lookup(obj_id)
        if row <= 0 or row >= self.valid.shape[0] or not self.valid[row]:
            return -1
        return row

    def apply_actions(self, actions: list) -> None:
        for action in actions:
            if action.kind == "delete":
                self.delete(action.obj.id)
            else:
                self.upsert(action.obj)


class ColumnarTasks:
    """Dense column mirror of the task table.

    Row lifetime: a task id interns into `_row` on first create; its row
    index is stable for the task's lifetime and recycled (free list) on
    delete. `valid[row]` is False only for never-used / freed rows.
    """

    def __init__(self, cap: int = _GROW):
        cap = max(cap, 1)
        self._row: dict[str, int] = {}
        self.ids: list[str | None] = []        # row -> task id (None = freed)
        self._free: list[int] = []
        self.nodes = IdVocab()
        self.services = IdVocab()
        self.state = np.zeros(cap, np.int32)
        self.desired = np.zeros(cap, np.int32)
        self.version = np.zeros(cap, np.int64)
        self.node_idx = np.zeros(cap, np.int32)
        self.service_idx = np.zeros(cap, np.int32)
        self.slot = np.zeros(cap, np.int64)
        # task spec-version index (-1 = None): the batched orchestrator's
        # dirty-candidate filter — version-mismatch rows are
        # EXACTLY the set the scalar is_task_dirty would spec-compare
        self.spec_version = np.zeros(cap, np.int64)
        self.valid = np.zeros(cap, bool)
        # service / node hot columns over the SHARED vocabs
        self.service_cols = ColumnarServices(self.services, cap)
        self.node_cols = ColumnarNodes(self.nodes, cap)
        # secret / config version mirrors: own vocabs, rows
        # never recycled — the dispatcher's columnar assignment diff
        # binds per-session known versions to these rows
        self.secret_cols = ColumnarDeps(cap)
        self.config_cols = ColumnarDeps(cap)
        # op counters (merged into store.op_counts views / debug/vars)
        self.stats: Counter = Counter()

    # ------------------------------------------------------------ capacity
    def _cap(self) -> int:
        return self.state.shape[0]

    _COLS = COLUMNS + ("valid",)

    def _ensure(self, rows_needed: int) -> None:
        _grow_columns(self, self._COLS, len(self.ids) + rows_needed)

    def _alloc_row(self, task_id: str) -> int:
        if self._free:
            row = self._free.pop()
            self.ids[row] = task_id
        else:
            self._ensure(1)
            row = len(self.ids)
            self.ids.append(task_id)
        self._row[task_id] = row
        return row

    # ----------------------------------------------------- lockstep writes
    def upsert_many(self, tasks: list) -> None:
        """Mirror a batch of created/updated task objects. One pass
        builds the row/value staging lists, then each column takes ONE
        flat fancy-index scatter — the bulk path the wave write-back
        rides (one commit = one scatter set, not one write per task)."""
        n = len(tasks)
        if not n:
            return
        rows = np.empty(n, np.int64)
        state = np.empty(n, np.int32)
        desired = np.empty(n, np.int32)
        version = np.empty(n, np.int64)
        node_idx = np.empty(n, np.int32)
        service_idx = np.empty(n, np.int32)
        slot = np.empty(n, np.int64)
        spec_version = np.empty(n, np.int64)
        row_of = self._row
        for j, t in enumerate(tasks):
            row = row_of.get(t.id)
            if row is None:
                row = self._alloc_row(t.id)
            rows[j] = row
            state[j] = int(t.status.state)
            desired[j] = int(t.desired_state)
            version[j] = t.meta.version.index
            node_idx[j] = self.nodes.intern(t.node_id)
            service_idx[j] = self.services.intern(t.service_id)
            slot[j] = t.slot
            spec_version[j] = (t.spec_version.index
                               if t.spec_version is not None else -1)
        self.state[rows] = state
        self.desired[rows] = desired
        self.version[rows] = version
        self.node_idx[rows] = node_idx
        self.service_idx[rows] = service_idx
        self.slot[rows] = slot
        self.spec_version[rows] = spec_version
        self.valid[rows] = True
        self.stats["rows_upserted"] += n
        self.stats["scatters"] += 1

    def delete(self, task_id: str) -> None:
        row = self._row.pop(task_id, None)
        if row is None:
            return
        self.ids[row] = None
        self.valid[row] = False
        self.node_idx[row] = 0
        self.service_idx[row] = 0
        self._free.append(row)
        self.stats["rows_deleted"] += 1

    def apply_actions(self, actions: list) -> None:
        """Commit-path lockstep hook: apply one committed changelist's
        task actions in order, coalescing consecutive creates/updates
        into one scatter batch."""
        pending: list = []
        for action in actions:
            if action.kind == "delete":
                if pending:
                    self.upsert_many(pending)
                    pending = []
                self.delete(action.obj.id)
            else:
                pending.append(action.obj)
        if pending:
            self.upsert_many(pending)

    def apply_service_actions(self, actions: list) -> None:
        """Commit-path lockstep hook for the service hot columns."""
        for action in actions:
            if action.kind == "delete":
                self.service_cols.delete(action.obj.id)
            else:
                self.service_cols.upsert(action.obj)
        self.stats["service_upserts"] += len(actions)

    def apply_node_actions(self, actions: list) -> None:
        """Commit-path lockstep hook for the node hot columns."""
        for action in actions:
            if action.kind == "delete":
                self.node_cols.delete(action.obj.id)
            else:
                self.node_cols.upsert(action.obj)
        self.stats["node_upserts"] += len(actions)

    def apply_secret_actions(self, actions: list) -> None:
        """Commit-path lockstep hook for the secret version mirror."""
        self.secret_cols.apply_actions(actions)
        self.stats["secret_upserts"] += len(actions)

    def apply_config_actions(self, actions: list) -> None:
        """Commit-path lockstep hook for the config version mirror."""
        self.config_cols.apply_actions(actions)
        self.stats["config_upserts"] += len(actions)

    def task_row(self, task_id: str) -> int:
        """Live row index for a task id, -1 when absent (rows recycle
        through the free list, so consumers holding a row must also hold
        the version they saw — see dispatcher/columnar_diff.py)."""
        return self._row.get(task_id, -1)

    # --------------------------------------------------- wave fast path
    def wave_codes(self, task_ids: list) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized wave-commit validation (the in-tx re-validation the
        object path did per task): returns (rows, codes) aligned with
        `task_ids`, codes in the ASSIGN_* space of store.memory — 0 ok,
        1 missing, 2 not assignable (dead / not PENDING / already has a
        node). Node readiness is the caller's overlay (it needs the node
        table)."""
        n = len(task_ids)
        rows = np.fromiter((self._row.get(t, -1) for t in task_ids),
                           np.int64, n)
        codes = np.zeros(n, np.int8)
        missing = rows < 0
        r = np.where(missing, 0, rows)
        bad = ((self.state[r] != int(TaskState.PENDING))
               | (self.node_idx[r] != 0)
               | (self.desired[r] > int(TaskState.COMPLETE))
               | ~self.valid[r])
        codes[bad] = 2
        codes[missing] = 1
        self.stats["wave_validations"] += 1
        return rows, codes

    def assign_rows(self, rows: np.ndarray, node_idx_vals: np.ndarray,
                    state: int, version: int) -> None:
        """The lazy wave's array write: whole-wave scatter into the hot
        columns. Object views for these rows are OWED — the caller must
        track them stale and materialize on first object read."""
        self.state[rows] = state
        self.node_idx[rows] = node_idx_vals
        self.version[rows] = version
        self.stats["assign_rows"] += int(rows.size)
        self.stats["assign_waves"] += 1

    # ------------------------------------------------------------ queries
    def __len__(self):
        return len(self._row)

    def row_of(self, task_id: str) -> int:
        return self._row.get(task_id, -1)

    def get(self, task_id: str):
        """(state, desired, version, node_id, service_id, slot) or None
        — the objectless hot read."""
        row = self._row.get(task_id)
        if row is None:
            return None
        self.stats["point_reads"] += 1
        return (int(self.state[row]), int(self.desired[row]),
                int(self.version[row]), self.nodes.name(self.node_idx[row]),
                self.services.name(self.service_idx[row]),
                int(self.slot[row]))

    def _rows_where(self, mask: np.ndarray) -> list[str]:
        self.stats["array_queries"] += 1
        ids = self.ids
        return [ids[r] for r in np.flatnonzero(mask & self.valid).tolist()]

    def ids_by_state(self, state: int) -> list[str]:
        return self._rows_where(self.state == int(state))

    def ids_by_node(self, node_id: str) -> list[str]:
        i = self.nodes.lookup(node_id)
        if i <= 0:
            return []
        return self._rows_where(self.node_idx == i)

    def ids_by_service(self, service_id: str) -> list[str]:
        i = self.services.lookup(service_id)
        if i < 0:
            return []
        return self._rows_where(self.service_idx == i)

    def count_by_state(self) -> dict[int, int]:
        self.stats["array_queries"] += 1
        states = self.state[self.valid]
        uniq, counts = np.unique(states, return_counts=True)
        return {int(s): int(c) for s, c in zip(uniq, counts)}

    # ------------------------------------------------- rebuild / parity
    def snapshot(self) -> dict:
        """Canonical (row-order-independent) image of the columns: every
        live task in sorted-id order, node/service indices resolved back
        to strings — bit-comparable against a from-scratch rebuild no
        matter how rows and vocab ids were historically assigned."""
        order = sorted(self._row)
        rows = np.fromiter((self._row[t] for t in order), np.int64,
                           len(order))
        return {
            "ids": order,
            "state": self.state[rows].copy(),
            "desired": self.desired[rows].copy(),
            "version": self.version[rows].copy(),
            "slot": self.slot[rows].copy(),
            "spec_version": self.spec_version[rows].copy(),
            "node_ids": [self.nodes.name(i) for i in self.node_idx[rows]],
            "service_ids": [self.services.name(i)
                            for i in self.service_idx[rows]],
        }

    @classmethod
    def rebuild(cls, tasks: list, services: list = (),
                nodes: list = (), secrets: list = (),
                configs: list = ()) -> "ColumnarTasks":
        """From-scratch mirror of a task list (the bit-equality oracle in
        tests, and the restore path). `services`/`nodes`/`secrets`/
        `configs` feed the hot sub-mirrors (the restore path passes
        them; parity tests that only compare task columns may omit
        them)."""
        col = cls(cap=max(len(tasks), 1))
        col.upsert_many(sorted(tasks, key=lambda t: t.id))
        for s in sorted(services, key=lambda s: s.id):
            col.service_cols.upsert(s)
        for n in sorted(nodes, key=lambda n: n.id):
            col.node_cols.upsert(n)
        for s in sorted(secrets, key=lambda s: s.id):
            col.secret_cols.upsert(s)
        for c in sorted(configs, key=lambda c: c.id):
            col.config_cols.upsert(c)
        return col

    # ------------------------------------------- snapshot section
    def to_snapshot_section(self) -> dict:
        """Serialize the LIVE column layout (row order, free rows, vocab
        ids intact) as a versioned, codec-safe dict — the optional
        `__columnar__` section MemoryStore.save() embeds so restore()
        can rebuild the hot mirrors by array ADOPTION instead of
        rebuild()'s O(objects) upsert walk. Must be called under the
        store lock (the commit path is the only other column writer);
        tobytes() copies, so the section is immune to later commits."""
        n = len(self.ids)
        sc, nc = self.service_cols, self.node_cols
        n_s, n_n = len(self.services), len(self.nodes)
        sec = {
            "v": COLUMNAR_SECTION_VERSION,
            "ids": list(self.ids),                 # None = freed row
            "nodes_vocab": list(self.nodes.names),
            "services_vocab": list(self.services.names),
            "tasks": {name: _enc(getattr(self, name)[:n])
                      for name in self._COLS},
            "service_cols": {name: _enc(getattr(sc, name)[:n_s])
                             for name in ColumnarServices._COLS},
            "node_cols": {name: _enc(getattr(nc, name)[:n_n])
                          for name in ColumnarNodes._COLS},
        }
        for key, dep in (("secret_cols", self.secret_cols),
                         ("config_cols", self.config_cols)):
            n_d = len(dep.vocab)
            sec[key] = {
                "vocab": list(dep.vocab.names),
                "cols": {name: _enc(getattr(dep, name)[:n_d])
                         for name in ColumnarDeps._COLS},
            }
        return sec

    @classmethod
    def adopt(cls, section, tasks: list, services: list = (),
              nodes: list = (), secrets: list = (),
              configs: list = ()) -> "ColumnarTasks | None":
        """Reconstruct a mirror from a to_snapshot_section() payload by
        array adoption, validated against the freshly restored object
        tables. Returns None on ANY inconsistency — unknown version,
        dtype/length drift, id-set mismatch vs the task table, version
        column disagreeing with the objects, vocab not covering an index
        — and the caller falls back to rebuild(). The parity bar: an
        adopted mirror's snapshot() is bit-equal to rebuild()'s."""
        if not isinstance(section, dict) \
                or section.get("v") != COLUMNAR_SECTION_VERSION:
            return None
        ids = section.get("ids")
        if not isinstance(ids, list) or not all(
                tid is None or isinstance(tid, str) for tid in ids):
            return None
        live = [tid for tid in ids if tid is not None]
        by_id = {t.id: t for t in tasks}
        if len(live) != len(set(live)) or set(live) != set(by_id):
            return None
        nv = _revocab(section.get("nodes_vocab"))
        sv = _revocab(section.get("services_vocab"))
        if nv is None or sv is None:
            return None
        n = len(ids)
        col = cls(cap=max(n, 1))
        tcols = section.get("tasks")
        if not isinstance(tcols, dict):
            return None
        for name in cls._COLS:
            arr = _dec(tcols.get(name), getattr(col, name).dtype, n)
            if arr is None:
                return None
            if n == 0:
                continue  # keep the constructor's 1-row zero capacity
            setattr(col, name, arr)
        col.ids = list(ids)
        col._row = {tid: r for r, tid in enumerate(ids) if tid is not None}
        col._free = [r for r, tid in enumerate(ids) if tid is None]
        col.nodes, col.services = nv, sv
        # cross-checks against the restored object tables: the live rows
        # must be valid, reference in-vocab ids, and carry each object's
        # exact version — a stale or torn section must never adopt
        rows = np.fromiter(col._row.values(), np.int64, len(col._row))
        if rows.size:
            if not col.valid[rows].all():
                return None
            if int(col.node_idx[rows].max(initial=0)) >= len(nv) \
                    or int(col.service_idx[rows].max(initial=0)) >= len(sv):
                return None
            versions = np.fromiter(
                (by_id[tid].meta.version.index for tid in col._row),
                np.int64, len(col._row))
            if not np.array_equal(col.version[rows], versions):
                return None
        freed = np.fromiter(col._free, np.int64, len(col._free))
        if freed.size and col.valid[freed].any():
            return None
        # sub-mirrors: columns sized exactly to their vocab
        col.service_cols = ColumnarServices(sv, cap=len(sv))
        col.node_cols = ColumnarNodes(nv, cap=len(nv))
        for owner, key, n_rows in (
                (col.service_cols, "service_cols", len(sv)),
                (col.node_cols, "node_cols", len(nv))):
            cols = section.get(key)
            if not isinstance(cols, dict):
                return None
            for name in owner._COLS:
                arr = _dec(cols.get(name), getattr(owner, name).dtype,
                           n_rows)
                if arr is None:
                    return None
                setattr(owner, name, arr)
        for key, attr in (("secret_cols", "secret_cols"),
                          ("config_cols", "config_cols")):
            payload = section.get(key)
            if not isinstance(payload, dict):
                return None
            dv = _revocab(payload.get("vocab"))
            cols = payload.get("cols")
            if dv is None or not isinstance(cols, dict):
                return None
            dep = ColumnarDeps(cap=len(dv))
            dep.vocab = dv
            for name in ColumnarDeps._COLS:
                arr = _dec(cols.get(name), getattr(dep, name).dtype,
                           len(dv))
                if arr is None:
                    return None
                setattr(dep, name, arr)
            setattr(col, attr, dep)
        return col

    @staticmethod
    def snapshots_equal(a: dict, b: dict) -> bool:
        if a["ids"] != b["ids"] or a["node_ids"] != b["node_ids"] \
                or a["service_ids"] != b["service_ids"]:
            return False
        return all(np.array_equal(a[k], b[k])
                   for k in ("state", "desired", "version", "slot",
                             "spec_version"))
