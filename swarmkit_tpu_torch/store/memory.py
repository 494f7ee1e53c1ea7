"""Transactional in-memory cluster-state store.

Re-derivation of the reference MemoryStore (manager/state/store/memory.go):
`view` / `update` / `batch` transactions over per-type tables with secondary
indexes, a changelist turned into events on commit, an optional raft Proposer
on the write path, and whole-store Save/Restore snapshots.

Where the reference rides hashicorp/go-memdb radix trees, we use plain dict
tables plus maintained secondary-index dicts — the scheduler's hot queries are
answered from its own dense arrays, so the store optimizes for
transactional correctness and event fidelity, not pointer-walk speed.

The port's copy of the JAX package's `store/memory.py`, without the
scheduler's columnar wave write-back (`assign_wave` and its lazily
materialized task views), which no part of the port calls yet.
"""
from __future__ import annotations

import threading
import time
from collections import Counter, defaultdict
from typing import Any, Callable, Iterable


from ..analysis import lockgraph as _lockgraph
from ..analysis.lockgraph import make_lock, make_rlock
from ..api.objects import (
    ALL_TABLES,
    Cluster,
    Config,
    EventCommit,
    EventCreate,
    EventDelete,
    EventUpdate,
    Extension,
    Network,
    Node,
    Resource,
    Secret,
    Service,
    StoreObject,
    Task,
    Version,
    Volume,
)
from . import by as by_mod
from ..utils.metrics import histogram
from .columnar import ColumnarTasks
from .watch import Channel, WatchQueue

# store tx latency + lock-hold timers (memory.go:99-112)
_read_tx_latency = histogram(
    "swarm_store_read_tx_latency_seconds", "read transaction duration")
_write_tx_latency = histogram(
    "swarm_store_write_tx_latency_seconds", "write transaction duration")
_lock_hold = histogram(
    "swarm_store_lock_hold_seconds", "update-lock hold duration")

# Batch limits (reference: manager/state/store/memory.go:47-51).
MAX_CHANGES_PER_TRANSACTION = 200
MAX_TRANSACTION_BYTES = 1.5 * 1024 * 1024

# Wedge detection (memory.go:80-81): update lock held longer than this is a bug.
WEDGE_TIMEOUT = 30.0

class SequenceConflict(Exception):
    """Version-checked update failed (reference ErrSequenceConflict)."""


class ExistError(Exception):
    pass


class NotExistError(Exception):
    pass


class StoreAction:
    """One element of a raft-replicated changelist (api/raft.pb.go StoreAction)."""

    CREATE, UPDATE, DELETE = "create", "update", "delete"

    def __init__(self, kind: str, obj: StoreObject):
        self.kind = kind
        self.obj = obj

    def __repr__(self):
        return f"StoreAction({self.kind}, {self.obj.TABLE}:{self.obj.id})"


class ReadTx:
    """Consistent read view. Objects returned are live references owned by the
    store — callers must treat them as immutable and `copy()` before mutating
    (same contract as the reference's returned protos)."""

    def __init__(self, store: "MemoryStore"):
        self._s = store

    def get(self, cls: type[StoreObject], id: str) -> StoreObject | None:
        return self._s._tables[cls.TABLE].get(id)

    def find(self, cls: type[StoreObject], *selectors) -> list[StoreObject]:
        return self._s._find(cls, selectors)

    # Typed convenience accessors (reference: tasks.go, nodes.go, ...).
    def get_task(self, id): return self.get(Task, id)
    def get_node(self, id): return self.get(Node, id)
    def get_service(self, id): return self.get(Service, id)
    def get_cluster(self, id): return self.get(Cluster, id)
    def get_secret(self, id): return self.get(Secret, id)
    def get_config(self, id): return self.get(Config, id)
    def get_network(self, id): return self.get(Network, id)
    def get_volume(self, id): return self.get(Volume, id)
    def get_extension(self, id): return self.get(Extension, id)
    def get_resource(self, id): return self.get(Resource, id)

    def find_tasks(self, *sel): return self.find(Task, *sel)
    def find_nodes(self, *sel): return self.find(Node, *sel)
    def find_services(self, *sel): return self.find(Service, *sel)
    def find_clusters(self, *sel): return self.find(Cluster, *sel)
    def find_secrets(self, *sel): return self.find(Secret, *sel)
    def find_configs(self, *sel): return self.find(Config, *sel)
    def find_networks(self, *sel): return self.find(Network, *sel)
    def find_volumes(self, *sel): return self.find(Volume, *sel)
    def find_extensions(self, *sel): return self.find(Extension, *sel)
    def find_resources(self, *sel): return self.find(Resource, *sel)


class WriteTx(ReadTx):
    """Buffered write transaction. Reads see the transaction's own writes."""

    def __init__(self, store: "MemoryStore"):
        super().__init__(store)
        self._writes: dict[tuple[str, str], StoreObject | None] = {}
        self._changelist: list[StoreAction] = []
        # (table, lower-name) -> id for names claimed by buffered writes:
        # the uniqueness checks in create/update stay O(1) instead of
        # rescanning every buffered write per call (a 10k-create tx would
        # otherwise be O(n^2) — bench_host_micro's store row caught this)
        self._buffered_names: dict[tuple[str, str], str] = {}

    def _name_in_use(self, cls, name: str, exclude_id: str) -> bool:
        """Name-uniqueness check: buffered claims via the tx-local map,
        committed objects via the store's name index — each O(1)."""
        lower = name.lower()
        owner = self._buffered_names.get((cls.TABLE, lower))
        if owner is not None and owner != exclude_id:
            return True
        for o in super().find(cls, by_mod.ByName(name)):
            if o.id == exclude_id:
                continue
            key = (cls.TABLE, o.id)
            if key in self._writes:
                cur = self._writes[key]
                if cur is None or (_name_of(cur) or "").lower() != lower:
                    continue  # deleted or renamed away within this tx
            return True
        return False

    def _claim_name(self, obj: StoreObject, old: StoreObject | None) -> None:
        if old is not None:
            old_name = (_name_of(old) or "").lower()
            if old_name:
                key = (obj.TABLE, old_name)
                if self._buffered_names.get(key) == obj.id:
                    del self._buffered_names[key]
        name = (_name_of(obj) or "").lower()
        if name:
            self._buffered_names[(obj.TABLE, name)] = obj.id

    # -- reads see buffered writes -----------------------------------------
    def get(self, cls: type[StoreObject], id: str) -> StoreObject | None:
        key = (cls.TABLE, id)
        if key in self._writes:
            return self._writes[key]
        return super().get(cls, id)

    def find(self, cls: type[StoreObject], *selectors) -> list[StoreObject]:
        base = {o.id: o for o in super().find(cls, *selectors)}
        # Overlay buffered writes: re-filter them, drop deletes.
        for (table, id), obj in self._writes.items():
            if table != cls.TABLE:
                continue
            base.pop(id, None)
            if obj is not None and by_mod.matches(obj, selectors):
                base[id] = obj
        return sorted(base.values(), key=lambda o: o.id)

    # -- mutations ----------------------------------------------------------
    def create(self, obj: StoreObject) -> None:
        if self.get(type(obj), obj.id) is not None:
            raise ExistError(f"{obj.TABLE} {obj.id} already exists")
        name = _name_of(obj)
        if obj.TABLE in ("service", "node") and name:
            if self._name_in_use(type(obj), name, exclude_id=obj.id):
                raise ExistError(f"{obj.TABLE} name {name!r} is in use")
        obj = obj.copy()
        self._writes[(obj.TABLE, obj.id)] = obj
        self._claim_name(obj, None)
        self._changelist.append(StoreAction(StoreAction.CREATE, obj))

    def update(self, obj: StoreObject) -> None:
        old = self.get(type(obj), obj.id)
        if old is None:
            raise NotExistError(f"{obj.TABLE} {obj.id} does not exist")
        if obj.meta.version.index != old.meta.version.index:
            raise SequenceConflict(
                f"{obj.TABLE} {obj.id}: update at version "
                f"{obj.meta.version.index}, store at {old.meta.version.index}"
            )
        new_name = _name_of(obj)
        if obj.TABLE in ("service", "node") and new_name \
                and new_name.lower() != _name_of(old).lower():
            # renames must keep names unique (reference services.go:98-104
            # ErrNameConflict)
            if self._name_in_use(type(obj), new_name, exclude_id=obj.id):
                raise ExistError(f"{obj.TABLE} name {new_name!r} is in use")
        obj = obj.copy()
        self._writes[(obj.TABLE, obj.id)] = obj
        self._claim_name(obj, old)
        self._changelist.append(StoreAction(StoreAction.UPDATE, obj))

    def delete(self, cls: type[StoreObject], id: str) -> None:
        old = self.get(cls, id)
        if old is None:
            raise NotExistError(f"{cls.TABLE} {id} does not exist")
        self._writes[(cls.TABLE, id)] = None
        old_name = (_name_of(old) or "").lower()
        if old_name and self._buffered_names.get(
                (cls.TABLE, old_name)) == id:
            del self._buffered_names[(cls.TABLE, old_name)]
        self._changelist.append(StoreAction(StoreAction.DELETE, old))


# single source of truth for object naming lives with the selectors
_name_of = by_mod._name_of


def _tracked_view(cb, tx):
    """Run a view callback inside the lockgraph hazard window: acquiring
    the dispatcher lock in here is the lock-order inversion the armed
    detector reports (docs/static_analysis.md). Disarmed cost: one module-global
    truthiness test. The ONE bracket both read paths (view,
    view_and_watch) share — the hazard window must cover every
    callback-under-store-lock path identically."""
    if _lockgraph._STATE is None:
        return cb(tx)
    _lockgraph.view_enter()
    try:
        return cb(tx)
    finally:
        _lockgraph.view_exit()


class MemoryStore:
    """reference: manager/state/store/memory.go:150-158."""

    def __init__(self, proposer=None):
        self._tables: dict[str, dict[str, StoreObject]] = {t: {} for t in ALL_TABLES}
        # secondary indexes: table -> index name -> key -> set[id]
        self._indexes: dict[str, dict[str, dict[Any, set[str]]]] = {
            t: defaultdict(lambda: defaultdict(set)) for t in ALL_TABLES
        }
        self._lock = make_rlock('store.memory.lock')          # guards table reads
        self._update_lock = make_lock('store.memory.update_lock')    # serializes writers (memory.go updateLock)
        self._update_lock_held_since: float | None = None
        self.wedge_timeout = WEDGE_TIMEOUT      # per-store override for tests
        self.proposer = proposer
        self.queue = WatchQueue()
        self._version = Version(0)  # commit version when no proposer drives it
        # Operation counters (test/bench observability — the dispatcher's
        # op-count regression guard asserts transactions-per-flush and
        # table-scan counts here instead of wall-clock timings, which are
        # meaningless on a contended 1-core host). Keys: "view_tx",
        # "update_tx", "find_<table>". Maintained under the locks the
        # counted operations already hold.
        self.op_counts: Counter = Counter()
        # Columnar mirror of the hot task table (store/columnar.py),
        # kept in lockstep by _commit and carried in snapshots.
        self.columnar = ColumnarTasks()

    # ------------------------------------------------------------------ reads
    def view(self, cb: Callable[[ReadTx], Any] | None = None):
        tx = ReadTx(self)
        if cb is None:
            return tx
        start = time.monotonic()
        try:
            with self._lock:
                self.op_counts["view_tx"] += 1
                return _tracked_view(cb, tx)
        finally:
            _read_tx_latency.observe(time.monotonic() - start)

    # ----------------------------------------------------------------- writes
    def update(self, cb: Callable[[WriteTx], Any]) -> Any:
        """Run a write transaction; commit through the proposer when present
        (memory.go:321-388)."""
        start = time.monotonic()
        with self._update_lock:
            self._update_lock_held_since = held = time.monotonic()
            self.op_counts["update_tx"] += 1
            try:
                tx = WriteTx(self)
                cb(tx)
                if not tx._changelist:
                    return None
                if self.proposer is not None:
                    actions = list(tx._changelist)
                    committed = threading.Event()

                    def commit_cb(version_index: int | None = None):
                        self._commit(tx, version_index=version_index)
                        committed.set()

                    self.proposer.propose_value(actions, commit_cb)
                    if not committed.is_set():
                        # Proposer accepted asynchronously; the commit callback
                        # must run before propose_value returns in-process
                        # implementations. Raft returns only after commit.
                        raise RuntimeError("proposer returned before commit")
                else:
                    self._commit(tx)
                return None
            finally:
                self._update_lock_held_since = None
                now = time.monotonic()
                _lock_hold.observe(now - held)
                _write_tx_latency.observe(now - start)

    def _commit(self, tx: WriteTx, version_index: int | None = None) -> None:
        now = time.time()
        with self._lock:
            # the mirror handle is read UNDER the lock: restore() swaps
            # self.columnar while holding it, and a pipelined commit
            # callback (raft worker, no update lock) racing a snapshot
            # install must scatter into the LIVE mirror, not the
            # discarded one
            col = self.columnar
            task_actions: list[StoreAction] = []
            service_actions: list[StoreAction] = []
            node_actions: list[StoreAction] = []
            secret_actions: list[StoreAction] = []
            config_actions: list[StoreAction] = []
            if version_index is not None:
                # replicated commits carry the raft entry index so object
                # versions agree on every replica
                self._version.index = max(self._version.index, version_index)
            else:
                self._version.index += 1
            version = Version(self._version.index)
            events: list[Any] = []
            for action in tx._changelist:
                obj = action.obj
                table = obj.TABLE
                if table == "task":
                    # columnar lockstep: mirrored AFTER the loop in one
                    # batched scatter per commit (touchMeta has stamped
                    # the version by then for creates/updates)
                    task_actions.append(action)
                elif table == "service":
                    service_actions.append(action)
                elif table == "node":
                    node_actions.append(action)
                elif table == "secret":
                    secret_actions.append(action)
                elif table == "config":
                    config_actions.append(action)
                if action.kind == StoreAction.DELETE:
                    stored = self._tables[table].pop(obj.id, None)
                    if stored is not None:
                        self._unindex(table, stored)
                    events.append(EventDelete(obj))
                    continue
                old = self._tables[table].get(obj.id)
                # touchMeta (memory.go:998-1020): stamp version + timestamps.
                obj.meta.version = Version(version.index)
                if action.kind == StoreAction.CREATE:
                    obj.meta.created_at = now
                obj.meta.updated_at = now
                if old is not None:
                    self._unindex(table, old)
                self._tables[table][obj.id] = obj
                self._index(table, obj)
                if action.kind == StoreAction.CREATE:
                    events.append(EventCreate(obj))
                else:
                    events.append(EventUpdate(obj, old=old))
            if task_actions:
                col.apply_actions(task_actions)
            if service_actions:
                col.apply_service_actions(service_actions)
            if node_actions:
                col.apply_node_actions(node_actions)
            if secret_actions:
                col.apply_secret_actions(secret_actions)
            if config_actions:
                col.apply_config_actions(config_actions)
            events.append(EventCommit(version))
        self.queue.publish_all(events)

    def apply_store_actions(self, actions: Iterable[StoreAction],
                            version_index: int | None = None) -> None:
        """Raft follower/replay apply path (memory.go:280-308): applies a
        committed changelist without consulting the proposer."""
        with self._update_lock:
            tx = WriteTx(self)
            for a in actions:
                if a.kind == StoreAction.CREATE:
                    tx.create(a.obj)
                elif a.kind == StoreAction.UPDATE:
                    # Replay trusts the leader's version; bypass conflict check.
                    cur = tx.get(type(a.obj), a.obj.id)
                    obj = a.obj.copy()
                    if cur is not None:
                        obj.meta.version = Version(cur.meta.version.index)
                        tx.update(obj)
                    else:
                        tx.create(obj)
                else:
                    try:
                        tx.delete(type(a.obj), a.obj.id)
                    except NotExistError:
                        pass
            self._commit(tx, version_index=version_index)

    def batch(self, cb: Callable[["Batch"], Any],
              pipeline_depth: int | None = None) -> None:
        """Split a large write into transactions of at most
        MAX_CHANGES_PER_TRANSACTION changes (memory.go:399-549).

        With `pipeline_depth` and a proposer that offers propose_async,
        sub-transactions are PIPELINED: up to depth proposals ride raft
        concurrently and share the group-commit plane's batched WAL
        fsync + replication flush, instead of paying one quorum RTT +
        fsync each. Commit callbacks still run in raft log order. Only
        safe when the sub-transactions touch disjoint objects (the bulk
        create/update shape Batch exists for): a later sub-transaction
        reads store state that does not yet include an in-flight one."""
        b = Batch(self, pipeline_depth=pipeline_depth)
        cb(b)
        b._flush()
        b._drain()

    # ----------------------------------------------------------------- events
    def watch_queue(self) -> WatchQueue:
        return self.queue

    def watch_from(self, version_index: int, matcher=None,
                   limit: int | None = -1) -> Channel:
        """Subscribe with version replay (memory.go:923-994 WatchFrom):
        committed changes after `version_index` are re-delivered as events
        ahead of the live stream. Requires a proposer that retains history
        (raft log); delivery is at-least-once across the replay/live seam.
        """
        with self._lock:
            cur = self._version.index
            replay: list[Any] = []
            if version_index < cur:
                if self.proposer is None or \
                        not hasattr(self.proposer, "changes_between"):
                    raise ValueError(
                        "watch_from needs a history-retaining proposer")
                try:
                    entry_changes = self.proposer.changes_between(
                        Version(version_index), Version(cur))
                except Exception as e:
                    # e.g. the range was compacted into a snapshot — signal
                    # "full resync required" uniformly, not a raft-internal
                    # error type
                    raise ValueError(f"cannot replay from {version_index}: {e}")
                for actions in entry_changes:
                    for sa in actions:
                        if sa.kind == StoreAction.CREATE:
                            replay.append(EventCreate(sa.obj))
                        elif sa.kind == StoreAction.UPDATE:
                            replay.append(EventUpdate(sa.obj))
                        else:
                            replay.append(EventDelete(sa.obj))
                replay.append(EventCommit(Version(cur)))
            ch = self.queue.watch(matcher, limit=limit)
            for ev in replay:
                ch._offer(ev)
        return ch

    def view_and_watch(self, cb: Callable[[ReadTx], Any] | None = None,
                       matcher=None, limit: int | None = -1) -> tuple[Any, Channel]:
        """Atomic snapshot-then-subscribe (memory.go:892-909): no event that
        post-dates the snapshot is missed, none that pre-dates it is delivered.
        limit=None subscribes unbounded (for trusted in-process control loops
        that must never be shed as slow subscribers)."""
        with self._lock:
            result = _tracked_view(cb, ReadTx(self)) if cb is not None \
                else None
            ch = self.queue.watch(matcher, limit=limit)
        return result, ch

    # -------------------------------------------------------------- snapshots
    def save(self) -> dict[str, list[StoreObject]]:
        """Marshal the whole store (memory.go:857-879 / api/snapshot.proto).

        The snapshot additionally carries a versioned `__columnar__`
        dense-column section so a restoring store can rebuild the hot
        mirrors by array adoption instead of the O(objects) rebuild walk.
        The section is advisory: restore() validates it against the
        object tables and silently falls back to rebuild() on any
        mismatch."""
        with self._lock:
            snap = {t: [o.copy() for o in objs.values()]
                    for t, objs in self._tables.items()}
            snap["__columnar__"] = self.columnar.to_snapshot_section()
            self.op_counts["save_columnar_section"] += 1
            return snap

    def restore(self, snapshot: dict[str, list[StoreObject]]) -> None:
        # NEVER mutate the caller's snapshot dict: raft holds it (the
        # leader's _snap_blob cache / recovered snapshot_data) and may
        # restore it again
        section = snapshot.get("__columnar__")
        with self._update_lock, self._lock:
            for t in self._tables:
                self._tables[t].clear()
                self._indexes[t].clear()
            max_index = 0
            for t, objs in snapshot.items():
                if t == "__columnar__":
                    continue
                for o in objs:
                    o = o.copy()
                    self._tables[t][o.id] = o
                    self._index(t, o)
                    max_index = max(max_index, o.meta.version.index)
            self._version.index = max(self._version.index, max_index)
            tables = self._tables
            adopted = None
            if section is not None:
                adopted = ColumnarTasks.adopt(
                    section,
                    list(tables["task"].values()),
                    services=list(tables["service"].values()),
                    nodes=list(tables["node"].values()),
                    secrets=list(tables["secret"].values()),
                    configs=list(tables["config"].values()))
            if adopted is not None:
                self.columnar = adopted
                self.op_counts["restore_columnar_adopted"] += 1
            else:
                self.columnar = ColumnarTasks.rebuild(
                    list(tables["task"].values()),
                    services=list(tables["service"].values()),
                    nodes=list(tables["node"].values()),
                    secrets=list(tables["secret"].values()),
                    configs=list(tables["config"].values()))
                self.op_counts["restore_columnar_rebuilt"] += 1

    @property
    def version(self) -> Version:
        return Version(self._version.index)

    def wedged(self) -> bool:
        """Wedge detector (memory.go:1024-1031)."""
        since = self._update_lock_held_since
        return since is not None and \
            time.monotonic() - since > self.wedge_timeout

    # ---------------------------------------------------------------- indexes
    def _index_entries(self, obj: StoreObject) -> list[tuple[str, Any]]:
        entries: list[tuple[str, Any]] = []
        name = _name_of(obj)
        if name:
            entries.append(("name", name.lower()))
        # custom indexes (reference by.go ByCustom: application-defined
        # secondary keys in Annotations.indices) — the extraction rule is
        # shared with the ByCustom matchers so index writer and reader
        # can never diverge
        for k, v in by_mod._indices_of(obj).items():
            entries.append(("custom", (k, v)))
        if isinstance(obj, Task):
            if obj.service_id:
                entries.append(("service", obj.service_id))
            if obj.node_id:
                entries.append(("node", obj.node_id))
            entries.append(("slot", (obj.service_id, obj.slot)))
            entries.append(("desired_state", int(obj.desired_state)))
            entries.append(("task_state", int(obj.status.state)))
        elif isinstance(obj, Node):
            entries.append(("role", int(obj.role)))
            entries.append(("membership", int(obj.spec.membership)))
        elif isinstance(obj, Volume):
            if obj.spec.group:
                entries.append(("group", obj.spec.group))
            if obj.spec.driver:
                entries.append(("driver", obj.spec.driver))
        elif isinstance(obj, Resource):
            if obj.kind:
                entries.append(("kind", obj.kind))
        return entries

    def _index(self, table: str, obj: StoreObject) -> None:
        for idx, key in self._index_entries(obj):
            self._indexes[table][idx][key].add(obj.id)

    def _unindex(self, table: str, obj: StoreObject) -> None:
        for idx, key in self._index_entries(obj):
            self._indexes[table][idx][key].discard(obj.id)

    def _find(self, cls: type[StoreObject], selectors) -> list[StoreObject]:
        with self._lock:
            self.op_counts[f"find_{cls.TABLE}"] += 1
            table = self._tables[cls.TABLE]
            ids = by_mod.candidate_ids(self._indexes[cls.TABLE], selectors)
            objs = table.values() if ids is None else (
                table[i] for i in ids if i in table)
            return sorted(
                (o for o in objs if by_mod.matches(o, selectors)),
                key=lambda o: o.id,
            )


class Batch:
    """reference: memory.go Batch — accumulates updates, flushing every
    MAX_CHANGES_PER_TRANSACTION changes as an independent transaction.
    With pipeline_depth set (and an async-capable proposer), flushed
    sub-transactions become in-flight raft proposals up to that depth."""

    def __init__(self, store: MemoryStore, pipeline_depth: int | None = None):
        self._store = store
        self._pending: list[Callable[[WriteTx], Any]] = []
        self._pending_changes = 0
        self._depth = pipeline_depth
        self._handles: list = []
        self.applied = 0
        self.committed = 0

    def update(self, cb: Callable[[WriteTx], Any]) -> None:
        self._pending.append(cb)
        self._pending_changes += 1
        self.applied += 1
        if self._pending_changes >= MAX_CHANGES_PER_TRANSACTION:
            self._flush()

    def update_many(self, cb: Callable[[WriteTx], Any], changes: int) -> None:
        """Grouped write: `cb(tx)` performs up to `changes` store writes
        in ONE callback — the scheduler's batched wave write-back rides
        this instead of one closure + one Batch entry per task.

        Flush semantics: with NO proposer, grouped callbacks coalesce
        into a single transaction regardless of size (nothing bounds an
        in-memory transaction but raft entry limits, and one commit =
        one table swap + one event batch — the op-count guard asserts
        exactly one update-tx per wave). With a proposer, flush
        boundaries respect MAX_CHANGES_PER_TRANSACTION like update(),
        so no raft entry exceeds the reference's bound — a grouped
        callback that would push the pending sub-transaction past the
        limit flushes the accumulated work FIRST (the caller still sizes
        `cb` chunks at or below the limit; an oversized single chunk is
        the caller's contract violation and ships alone)."""
        if self._store.proposer is not None and self._pending and \
                self._pending_changes + changes > MAX_CHANGES_PER_TRANSACTION:
            self._flush()
        self._pending.append(cb)
        self._pending_changes += changes
        self.applied += changes
        if self._store.proposer is not None and \
                self._pending_changes >= MAX_CHANGES_PER_TRANSACTION:
            self._flush()

    def _pipelined(self) -> bool:
        return bool(self._depth and self._depth > 1
                    and self._store.proposer is not None
                    and hasattr(self._store.proposer, "propose_async"))

    def _flush(self) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        changes, self._pending_changes = self._pending_changes, 0

        def run_all(tx: WriteTx):
            for cb in pending:
                cb(tx)

        if self._pipelined():
            self._flush_async(run_all)
        else:
            self._store.update(run_all)
        self.committed += changes

    def _flush_async(self, run_all: Callable[[WriteTx], Any]) -> None:
        """Build the sub-transaction under the update lock, hand the
        changelist to propose_async, and release the lock WITHOUT waiting
        for the commit — the raft worker's group-commit flush batches the
        in-flight window's WAL write + replication. The commit callback
        (table write-back + events) runs on the raft worker in log order,
        exactly like a propose_value commit does."""
        store = self._store
        with store._update_lock:
            tx = WriteTx(store)
            run_all(tx)
            if not tx._changelist:
                return
            actions = list(tx._changelist)

            def commit_cb(version_index: int | None = None):
                store._commit(tx, version_index=version_index)

            handle = store.proposer.propose_async(actions, commit_cb)
        self._handles.append(handle)
        while len(self._handles) >= (self._depth or 1):
            self._handles.pop(0).result()

    def _drain(self) -> None:
        """Wait out every in-flight pipelined proposal; raise the first
        failure (same typed errors a blocking update would raise)."""
        handles, self._handles = self._handles, []
        first_err = None
        for h in handles:
            try:
                h.result()
            except Exception as exc:
                if first_err is None:
                    first_err = exc
        if first_err is not None:
            raise first_err
