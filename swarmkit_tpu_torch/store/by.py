"""Find selectors (reference: manager/state/store/by.go, 246 lines).

A selector is a small object with `match(obj)` and optionally an index hint
(`index_key()`), which the store uses to narrow the candidate set before
exact matching — the analogue of memdb's secondary-index iterators
(memory.go:663-824 findIterators).

The port's copy of the JAX package's `store/by.py`.
"""
from __future__ import annotations

from typing import Any


class By:
    def match(self, obj) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError

    def index_key(self) -> tuple[str, Any] | None:
        return None


class All(By):
    def match(self, obj) -> bool:
        return True


class ByID(By):
    def __init__(self, id: str):
        self.id = id

    def match(self, obj) -> bool:
        return obj.id == self.id


class ByIDPrefix(By):
    def __init__(self, prefix: str):
        self.prefix = prefix

    def match(self, obj) -> bool:
        return obj.id.startswith(self.prefix)


def _name_of(obj) -> str:
    spec = getattr(obj, "spec", None)
    ann = getattr(spec, "annotations", None) or getattr(obj, "annotations", None)
    return getattr(ann, "name", "") if ann is not None else ""


class ByName(By):
    def __init__(self, name: str):
        self.name = name.lower()

    def match(self, obj) -> bool:
        return _name_of(obj).lower() == self.name

    def index_key(self):
        return ("name", self.name)


class ByNamePrefix(By):
    def __init__(self, prefix: str):
        self.prefix = prefix.lower()

    def match(self, obj) -> bool:
        return _name_of(obj).lower().startswith(self.prefix)


class ByServiceID(By):
    def __init__(self, service_id: str):
        self.service_id = service_id

    def match(self, obj) -> bool:
        return getattr(obj, "service_id", None) == self.service_id

    def index_key(self):
        return ("service", self.service_id)


class ByNodeID(By):
    def __init__(self, node_id: str):
        self.node_id = node_id

    def match(self, obj) -> bool:
        return getattr(obj, "node_id", None) == self.node_id

    def index_key(self):
        return ("node", self.node_id)


class BySlot(By):
    def __init__(self, service_id: str, slot: int):
        self.service_id = service_id
        self.slot = slot

    def match(self, obj) -> bool:
        return (getattr(obj, "service_id", None) == self.service_id
                and getattr(obj, "slot", None) == self.slot)

    def index_key(self):
        return ("slot", (self.service_id, self.slot))


class ByDesiredState(By):
    def __init__(self, state):
        self.state = int(state)

    def match(self, obj) -> bool:
        return int(getattr(obj, "desired_state", -1)) == self.state

    def index_key(self):
        return ("desired_state", self.state)


class ByTaskState(By):
    def __init__(self, state):
        self.state = int(state)

    def match(self, obj) -> bool:
        status = getattr(obj, "status", None)
        return status is not None and int(status.state) == self.state

    def index_key(self):
        return ("task_state", self.state)


class ByRole(By):
    def __init__(self, role):
        self.role = int(role)

    def match(self, obj) -> bool:
        return int(getattr(obj, "role", -1)) == self.role

    def index_key(self):
        return ("role", self.role)


class ByMembership(By):
    def __init__(self, membership):
        self.membership = int(membership)

    def match(self, obj) -> bool:
        spec = getattr(obj, "spec", None)
        return spec is not None and int(getattr(spec, "membership", -1)) == self.membership

    def index_key(self):
        return ("membership", self.membership)


class ByVolumeGroup(By):
    def __init__(self, group: str):
        self.group = group

    def match(self, obj) -> bool:
        return getattr(obj.spec, "group", None) == self.group

    def index_key(self):
        return ("group", self.group)


class ByDriver(By):
    def __init__(self, driver: str):
        self.driver = driver

    def match(self, obj) -> bool:
        return getattr(obj.spec, "driver", None) == self.driver

    def index_key(self):
        return ("driver", self.driver)


class ByKind(By):
    def __init__(self, kind: str):
        self.kind = kind

    def match(self, obj) -> bool:
        return getattr(obj, "kind", None) == self.kind

    def index_key(self):
        return ("kind", self.kind)


class ByReferencedSecretID(By):
    def __init__(self, secret_id: str):
        self.secret_id = secret_id

    def match(self, obj) -> bool:
        spec = getattr(obj, "spec", None)
        task_spec = getattr(spec, "task", spec)
        runtime = getattr(task_spec, "runtime", None)
        if runtime is None:
            return False
        return any(ref.secret_id == self.secret_id for ref in runtime.secrets)


class ByReferencedConfigID(By):
    def __init__(self, config_id: str):
        self.config_id = config_id

    def match(self, obj) -> bool:
        spec = getattr(obj, "spec", None)
        task_spec = getattr(spec, "task", spec)
        runtime = getattr(task_spec, "runtime", None)
        if runtime is None:
            return False
        return any(ref.config_id == self.config_id for ref in runtime.configs)


def _indices_of(obj) -> dict:
    spec = getattr(obj, "spec", None)
    ann = getattr(spec, "annotations", None) or getattr(obj, "annotations", None)
    return getattr(ann, "indices", None) or {}


class ByCustom(By):
    """Search a custom index (Annotations.indices) for an exact value
    (reference: by.go:198-214 ByCustom)."""

    def __init__(self, index: str, value: str):
        self.index = index
        self.value = value

    def match(self, obj) -> bool:
        return _indices_of(obj).get(self.index) == self.value

    def index_key(self):
        return ("custom", (self.index, self.value))


class ByCustomPrefix(By):
    """Custom-index prefix search (reference: by.go:216-232)."""

    def __init__(self, index: str, prefix: str):
        self.index = index
        self.prefix = prefix

    def match(self, obj) -> bool:
        v = _indices_of(obj).get(self.index)
        return v is not None and v.startswith(self.prefix)


class Or(By):
    def __init__(self, *selectors: By):
        self.selectors = selectors

    def match(self, obj) -> bool:
        return any(s.match(obj) for s in self.selectors)


class And(By):
    def __init__(self, *selectors: By):
        self.selectors = selectors

    def match(self, obj) -> bool:
        return all(s.match(obj) for s in self.selectors)


def matches(obj, selectors) -> bool:
    """Multiple top-level selectors OR together (reference store.FindTasks(by.Or...))
    — a single selector list behaves like Or, matching the reference's Find."""
    if not selectors:
        return True
    return any(s.match(obj) for s in selectors)


def candidate_ids(indexes, selectors) -> set[str] | None:
    """Use index hints to narrow candidates; None means full scan."""
    if not selectors:
        return None
    out: set[str] = set()
    for s in selectors:
        hint = s.index_key() if isinstance(s, By) else None
        if hint is None:
            return None  # at least one selector needs a full scan
        idx, key = hint
        out |= indexes.get(idx, {}).get(key, set())
    return out
