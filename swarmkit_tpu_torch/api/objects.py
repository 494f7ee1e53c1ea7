"""Store objects: the versioned, replicated cluster state.

Re-derivation of the reference's object protos (api/objects.proto) and the
StoreObject abstraction (api/storeobject.go:19-27): every object exposes
id/meta/copy and maps to create/update/delete events. Where the reference
generates this via protobuf plugins, we use one dataclass base.
"""
from __future__ import annotations

import copy as _copy
from dataclasses import dataclass, field
from typing import Any

from .. import native
from .specs import (
    Annotations,
    ClusterSpec,
    ConfigSpec,
    ExtensionSpec,
    NetworkSpec,
    NodeDescription,
    NodeSpec,
    SecretSpec,
    ServiceSpec,
    TaskSpec,
    VolumeSpec,
)
from .types import NodeStatusState, TaskState


@dataclass
class Version:
    """Optimistic-concurrency version: the raft index of the last write
    (reference: api/objects.proto Meta.Version; ErrSequenceConflict on mismatch)."""

    index: int = 0


@dataclass
class Meta:
    version: Version = field(default_factory=Version)
    created_at: float = 0.0
    updated_at: float = 0.0


@dataclass
class StoreObject:
    """Base for everything the store replicates (api/storeobject.go:19-27).

    Objects are tree-shaped: no field shares a mutable substructure
    with another field of the same object."""

    id: str = ""
    meta: Meta = field(default_factory=Meta)

    # Table name, filled in by subclasses; used by the store and snapshots.
    TABLE = ""

    def copy(self):
        # the object model is tree-shaped (no cycles, no aliasing between
        # fields), so the native tree copier applies; unknown subtrees in
        # `Any` fields go through deepcopy one by one, and the whole call
        # does without the native module (tests/test_torch_native.py pins
        # the equivalence)
        hostops = native.load()
        if hostops is not None:
            return hostops.tree_copy(self, _copy.deepcopy)
        return _copy.deepcopy(self)

    def get_id(self) -> str:
        return self.id


@dataclass
class TaskStatus:
    """Observed state, written only by the worker path
    (reference: api/objects.proto:244-249 comment on observed vs desired)."""

    timestamp: float = 0.0
    state: TaskState = TaskState.NEW
    message: str = ""
    err: str = ""
    # container/runtime exit status
    exit_code: int | None = None
    port_status: list[Any] = field(default_factory=list)
    applied_by: str = ""  # node that reported it


@dataclass
class Task(StoreObject):
    """reference: api/objects.proto:183-276."""

    TABLE = "task"

    spec: TaskSpec = field(default_factory=TaskSpec)
    service_id: str = ""
    slot: int = 0  # replicated-mode slot; 0 for global mode
    node_id: str = ""  # set by the scheduler exactly once (task immutability)
    annotations: Annotations = field(default_factory=Annotations)
    service_annotations: Annotations = field(default_factory=Annotations)
    status: TaskStatus = field(default_factory=TaskStatus)
    desired_state: TaskState = TaskState.NEW
    spec_version: Version | None = None
    endpoint: Any = None
    log_driver: Any = None
    networks: list[Any] = field(default_factory=list)
    assigned_generic_resources: dict[str, Any] = field(default_factory=dict)
    volumes: list[str] = field(default_factory=list)  # VolumeAttachment ids
    job_iteration: Version | None = None


@dataclass
class Service(StoreObject):
    TABLE = "service"

    spec: ServiceSpec = field(default_factory=ServiceSpec)
    previous_spec: ServiceSpec | None = None
    spec_version: Version = field(default_factory=Version)
    previous_spec_version: Version | None = None
    endpoint: Any = None
    update_status: Any = None
    job_status: Any = None
    pending_delete: bool = False


@dataclass
class NodeStatus:
    state: NodeStatusState = NodeStatusState.UNKNOWN
    message: str = ""
    addr: str = ""


@dataclass
class ManagerStatus:
    raft_id: int = 0
    addr: str = ""
    leader: bool = False
    reachability: str = "unknown"  # unknown|unreachable|reachable


@dataclass
class NodeCertificate:
    """Per-node certificate record replicated in the store
    (reference: api/types.proto Certificate: role/CSR/status/certificate/CN)."""

    role: int = 0  # NodeRole.WORKER
    csr_pem: bytes = b""
    status_state: int = 0  # IssuanceState
    status_err: str = ""
    certificate_pem: bytes = b""
    cn: str = ""
    # cluster root_ca.last_forced_rotation at CSR submission: the rotation
    # reconciler finishes only when every node re-CSR'd under the current
    # epoch — i.e. the node itself fetched and swapped to the new cert, not
    # merely that the server re-signed an old CSR (premature trust-anchor
    # swap would wedge nodes still presenting old-signed leafs)
    rotation_epoch: int = 0


@dataclass
class RootCAObj:
    """Cluster root CA material held on the Cluster object
    (reference: api/types.proto RootCA: key/cert/digest/join tokens/rotation)."""

    ca_key_pem: bytes = b""
    ca_cert_pem: bytes = b""
    cert_digest: str = ""
    join_token_worker: str = ""
    join_token_manager: str = ""
    root_rotation: Any = None
    last_forced_rotation: int = 0


@dataclass
class Node(StoreObject):
    TABLE = "node"

    spec: NodeSpec = field(default_factory=NodeSpec)
    description: NodeDescription | None = None
    status: NodeStatus = field(default_factory=NodeStatus)
    manager_status: ManagerStatus | None = None
    attachments: list[Any] = field(default_factory=list)
    certificate: Any = None
    role: int = 0  # observed role (cert role); spec.desired_role is desired
    vxlan_udp_port: int = 0


@dataclass
class Cluster(StoreObject):
    TABLE = "cluster"

    spec: ClusterSpec = field(default_factory=ClusterSpec)
    root_ca: Any = None
    network_bootstrap_keys: list[Any] = field(default_factory=list)
    encryption_key_lamport_clock: int = 0
    blacklisted_certificates: dict[str, Any] = field(default_factory=dict)
    unlock_keys: list[Any] = field(default_factory=list)
    fips: bool = False
    default_address_pool: list[str] = field(default_factory=list)
    subnet_size: int = 24
    vxlan_udp_port: int = 4789


@dataclass
class Secret(StoreObject):
    TABLE = "secret"

    spec: SecretSpec = field(default_factory=SecretSpec)
    internal: bool = False


@dataclass
class Config(StoreObject):
    TABLE = "config"

    spec: ConfigSpec = field(default_factory=ConfigSpec)


@dataclass
class Network(StoreObject):
    TABLE = "network"

    spec: NetworkSpec = field(default_factory=NetworkSpec)
    driver_state: Any = None
    ipam: Any = None
    pending_delete: bool = False


@dataclass
class Volume(StoreObject):
    TABLE = "volume"

    spec: VolumeSpec = field(default_factory=VolumeSpec)
    publish_status: list[Any] = field(default_factory=list)
    volume_info: Any = None
    pending_delete: bool = False


@dataclass
class Extension(StoreObject):
    TABLE = "extension"

    annotations: Annotations = field(default_factory=Annotations)
    description: str = ""


@dataclass
class Resource(StoreObject):
    """Custom extension-kind resources (reference: api/objects.proto Resource)."""

    TABLE = "resource"

    annotations: Annotations = field(default_factory=Annotations)
    kind: str = ""
    payload: bytes = b""


ALL_TABLES: dict[str, type[StoreObject]] = {
    cls.TABLE: cls
    for cls in (Task, Service, Node, Cluster, Secret, Config, Network, Volume, Extension, Resource)
}


# ---------------------------------------------------------------------------
# Events. The reference generates EventCreate<T>/EventUpdate<T>/EventDelete<T>
# per object via the storeobject protobuf plugin; we use one generic family.
# ---------------------------------------------------------------------------


@dataclass
class StoreEvent:
    obj: StoreObject

    @property
    def table(self) -> str:
        return self.obj.TABLE


@dataclass
class EventCreate(StoreEvent):
    pass


@dataclass
class EventUpdate(StoreEvent):
    old: StoreObject | None = None


@dataclass
class EventDelete(StoreEvent):
    pass


@dataclass
class EventCommit:
    """Published after each committed transaction (manager/state/watch.go:10)."""

    version: Version = field(default_factory=Version)
