"""Spec types: the *desired* half of every object.

Re-derivation of the reference's spec protos (api/specs.proto, 581 lines).
Specs are plain frozen-ish dataclasses; objects embed a spec plus observed
runtime state. Deep-copy semantics mirror the generated deepcopy plugin
(protobuf/plugin/deepcopy in the reference).
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any

from .. import native
from .types import (
    NodeAvailability,
    NodeRole,
    RestartCondition,
    ServiceMode,
    UpdateFailureAction,
    UpdateOrder,
)


@dataclass
class Annotations:
    name: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    # custom indexes (reference api/types.proto Annotations.indices,
    # IndexEntry key/val): application-defined secondary keys that watch
    # selectors and custom find-by queries match on
    indices: dict[str, str] = field(default_factory=dict)


@dataclass
class Platform:
    """reference: api/types.proto Platform (os/architecture)."""

    architecture: str = ""
    os: str = ""


@dataclass
class Resources:
    """Scalar + generic resources (reference: api/types.proto Resources).

    nano_cpus follows the reference's NanoCPUs convention (1e9 == one core).
    `generic` maps resource-kind -> quantity for discrete generic resources
    (api/genericresource in the reference); named generic resources carry a
    set of string ids per kind.
    """

    nano_cpus: int = 0
    memory_bytes: int = 0
    generic: dict[str, int] = field(default_factory=dict)
    named_generic: dict[str, set[str]] = field(default_factory=dict)

    def copy(self) -> "Resources":
        return Resources(
            nano_cpus=self.nano_cpus,
            memory_bytes=self.memory_bytes,
            generic=dict(self.generic),
            named_generic={k: set(v) for k, v in self.named_generic.items()},
        )


@dataclass
class ResourceRequirements:
    reservations: Resources = field(default_factory=Resources)
    limits: Resources = field(default_factory=Resources)


@dataclass
class PlacementPreference:
    """Spread-over-label preference (reference: api/specs.proto Placement)."""

    spread_descriptor: str = ""  # e.g. "node.labels.datacenter"


@dataclass
class Placement:
    """reference: api/specs.proto Placement."""

    constraints: list[str] = field(default_factory=list)
    preferences: list[PlacementPreference] = field(default_factory=list)
    platforms: list[Platform] = field(default_factory=list)
    max_replicas: int = 0  # 0 == unlimited (MaxReplicasFilter)


@dataclass
class RestartPolicy:
    """reference: api/types.proto RestartPolicy; defaults api/defaults/service.go."""

    condition: RestartCondition = RestartCondition.ANY
    delay: float = 5.0  # seconds (reference default 5s)
    max_attempts: int = 0  # 0 == unlimited
    window: float = 0.0  # seconds; 0 == unbounded window


@dataclass
class UpdateConfig:
    """Rolling-update knobs (reference: api/types.proto UpdateConfig)."""

    parallelism: int = 1
    delay: float = 0.0
    failure_action: UpdateFailureAction = UpdateFailureAction.PAUSE
    monitor: float = 5.0
    max_failure_ratio: float = 0.0
    order: UpdateOrder = UpdateOrder.STOP_FIRST


@dataclass
class SecretReference:
    secret_id: str = ""
    secret_name: str = ""
    target: str = ""  # filename in the task sandbox


@dataclass
class ConfigReference:
    config_id: str = ""
    config_name: str = ""
    target: str = ""


@dataclass
class VolumeMount:
    source: str = ""  # volume name, or "group:<name>" for cluster volumes
    target: str = ""
    readonly: bool = False
    type: str = "volume"  # "bind" | "volume" | "tmpfs" | "csi"


@dataclass
class PortConfig:
    """reference: api/types.proto PortConfig (host-port publishing)."""

    name: str = ""
    protocol: str = "tcp"
    target_port: int = 0
    published_port: int = 0  # 0 == dynamically assigned
    publish_mode: str = "ingress"  # "ingress" | "host"


@dataclass
class EndpointSpec:
    mode: str = "vip"  # "vip" | "dnsrr"
    ports: list[PortConfig] = field(default_factory=list)


@dataclass
class NetworkAttachmentConfig:
    target: str = ""  # network id or name
    aliases: list[str] = field(default_factory=list)
    addresses: list[str] = field(default_factory=list)


@dataclass
class ContainerSpec:
    """The default runtime spec (reference: api/specs.proto ContainerSpec).

    The executor interprets it; the fake executor in tests only sleeps/exits.
    """

    image: str = ""
    command: list[str] = field(default_factory=list)
    args: list[str] = field(default_factory=list)
    env: list[str] = field(default_factory=list)
    labels: dict[str, str] = field(default_factory=dict)
    dir: str = ""
    user: str = ""
    secrets: list[SecretReference] = field(default_factory=list)
    configs: list[ConfigReference] = field(default_factory=list)
    mounts: list[VolumeMount] = field(default_factory=list)
    stop_grace_period: float = 10.0
    pull_options: dict[str, str] = field(default_factory=dict)
    hosts: list[str] = field(default_factory=list)


@dataclass
class NetworkAttachmentSpec:
    """Attachment-task runtime: bind an existing engine container to a
    cluster network (reference: api/specs.proto NetworkAttachmentSpec)."""

    container_id: str = ""


@dataclass
class TaskSpec:
    """reference: api/specs.proto TaskSpec (oneof runtime:
    container | attachment)."""

    runtime: ContainerSpec | None = None
    attachment: NetworkAttachmentSpec | None = None
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    restart: RestartPolicy = field(default_factory=RestartPolicy)
    placement: Placement = field(default_factory=Placement)
    networks: list[NetworkAttachmentConfig] = field(default_factory=list)
    log_driver: dict[str, Any] | None = None
    force_update: int = 0  # bumping forces a task refresh (spec-equal but dirty)


@dataclass
class JobSpec:
    max_concurrent: int = 0
    total_completions: int = 0


@dataclass
class ServiceSpec:
    """reference: api/specs.proto ServiceSpec."""

    annotations: Annotations = field(default_factory=Annotations)
    task: TaskSpec = field(default_factory=TaskSpec)
    mode: ServiceMode = ServiceMode.REPLICATED
    replicas: int = 1  # replicated mode
    job: JobSpec = field(default_factory=JobSpec)
    update: UpdateConfig = field(default_factory=UpdateConfig)
    rollback: UpdateConfig | None = None
    endpoint: EndpointSpec = field(default_factory=EndpointSpec)
    networks: list[NetworkAttachmentConfig] = field(default_factory=list)


@dataclass
class NodeDescription:
    """What a node reports about itself (reference: api/objects.proto Node.Description)."""

    hostname: str = ""
    platform: Platform = field(default_factory=Platform)
    resources: Resources = field(default_factory=Resources)
    engine_labels: dict[str, str] = field(default_factory=dict)
    plugins: list[tuple[str, str]] = field(default_factory=list)  # (type, name)
    fips: bool = False
    csi_plugins: list[str] = field(default_factory=list)
    # plugin name -> NodeCSIInfo (csi node id + accessible topology segments)
    csi_info: dict[str, "NodeCSIInfo"] = field(default_factory=dict)


@dataclass
class NodeCSIInfo:
    """Per-plugin CSI identity a node reports
    (reference: api/objects.proto NodeCSIInfo)."""

    plugin_name: str = ""
    node_id: str = ""  # the *CSI* node id, plugin-scoped
    max_volumes_per_node: int = 0
    accessible_topology: dict[str, str] = field(default_factory=dict)


@dataclass
class NodeSpec:
    annotations: Annotations = field(default_factory=Annotations)
    desired_role: NodeRole = NodeRole.WORKER
    membership: int = 1  # NodeMembership.ACCEPTED
    availability: NodeAvailability = NodeAvailability.ACTIVE


@dataclass
class RaftConfig:
    """reference: api/types.proto RaftConfig; defaults manager/manager.go:1194+."""

    snapshot_interval: int = 10000
    keep_old_snapshots: int = 0
    log_entries_for_slow_followers: int = 500
    election_tick: int = 10
    heartbeat_tick: int = 1


@dataclass
class DispatcherConfig:
    heartbeat_period: float = 5.0  # reference: manager/dispatcher/dispatcher.go:28-53


@dataclass
class CAConfig:
    """reference: api/specs.proto CAConfig — the operator's steering wheel
    for the CA (controlapi/ca_rotation.go validates + applies it)."""

    node_cert_expiry: float = 90 * 24 * 3600.0
    # [{"protocol": "cfssl", "url": "https://...", "ca_cert": pem?}, ...]
    external_cas: list[dict[str, Any]] = field(default_factory=list)
    # bump to force a root rotation with a freshly generated root
    force_rotate: int = 0
    # operator-supplied signing material: cert+key rotates to that root;
    # cert alone requires a matching external CA entry to do the signing
    signing_ca_cert: bytes = b""
    signing_ca_key: bytes = b""


@dataclass
class EncryptionConfig:
    auto_lock_managers: bool = False


@dataclass
class TaskDefaults:
    log_driver: dict[str, Any] | None = None


@dataclass
class ClusterSpec:
    """Replicated runtime configuration (reference: api/specs.proto ClusterSpec)."""

    annotations: Annotations = field(default_factory=Annotations)
    raft: RaftConfig = field(default_factory=RaftConfig)
    dispatcher: DispatcherConfig = field(default_factory=DispatcherConfig)
    ca: CAConfig = field(default_factory=CAConfig)
    encryption: EncryptionConfig = field(default_factory=EncryptionConfig)
    task_defaults: TaskDefaults = field(default_factory=TaskDefaults)
    task_history_retention_limit: int = 5


@dataclass
class SecretSpec:
    annotations: Annotations = field(default_factory=Annotations)
    data: bytes = b""
    driver: dict[str, Any] | None = None
    templating: bool = False


@dataclass
class ConfigSpec:
    annotations: Annotations = field(default_factory=Annotations)
    data: bytes = b""
    templating: bool = False


@dataclass
class NetworkSpec:
    annotations: Annotations = field(default_factory=Annotations)
    driver_config: dict[str, Any] | None = None
    ipv6_enabled: bool = False
    internal: bool = False
    attachable: bool = False
    ingress: bool = False
    ipam: dict[str, Any] | None = None


@dataclass
class VolumeAccessMode:
    """reference: api/types.proto VolumeAccessMode."""

    scope: str = "single"  # "single" | "multi"
    sharing: str = "none"  # "none" | "readonly" | "onewriter" | "all"
    block: bool = False


@dataclass
class VolumeSpec:
    annotations: Annotations = field(default_factory=Annotations)
    group: str = ""
    driver: str = ""
    access_mode: VolumeAccessMode = field(default_factory=VolumeAccessMode)
    secrets: dict[str, str] = field(default_factory=dict)
    accessibility_requirements: dict[str, Any] | None = None
    capacity_range: tuple[int, int] | None = None
    availability: str = "active"  # "active" | "pause" | "drain"


@dataclass
class ExtensionSpec:
    annotations: Annotations = field(default_factory=Annotations)
    description: str = ""


def deepcopy_spec(spec):
    """Uniform deep-copy, standing in for the reference's generated
    CopyFrom: the native tree copier when it is built (specs are
    tree-shaped dataclasses), `copy.deepcopy` otherwise."""
    hostops = native.load()
    if hostops is not None:
        return hostops.tree_copy(spec, copy.deepcopy)
    return copy.deepcopy(spec)


def spec_equal(a, b) -> bool:
    """Spec equality as used for dirtiness checks (orchestrator/task.go
    IsTaskDirty). Dataclass `==` compares fields recursively and is ~10×
    cheaper than two asdict walks; the asdict comparison remains as the
    widening fallback for structurally-different-but-equivalent `Any`
    payloads (e.g. a dataclass vs its dict form), preserving the old
    result for every pair the fast path can't prove equal."""
    if type(a) is type(b) and a == b:
        return True
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def normalize_nones(obj):
    """Fold hand-crafted Nones back to field defaults, recursively and in
    place (returns `obj` for chaining).

    The reference's wire makes this unrepresentable: a non-pointer proto
    field cannot be null — a client can only OMIT it, which decodes as
    the zero value (specs.proto's Task, Placement, Resources, ... are
    all non-pointer). This framework's msgpack codec rebuilds dataclasses
    without per-field type checks, so a hand-crafted payload CAN carry
    None where the dataclass declares a non-None default — and every
    validator and control loop downstream is written against the proto
    guarantee. Called at the validation boundary so both the checks and
    the stored spec see proto-shaped objects.

    Fields DECLARED optional (default None, e.g. ServiceSpec.rollback,
    TaskSpec.runtime) keep None — those are the proto pointer fields.
    None ELEMENTS inside lists and None dict values are dropped: proto
    repeated and map fields cannot carry null entries either (an absent
    element is simply not sent).
    """
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        return obj
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            if f.default_factory is not dataclasses.MISSING:
                setattr(obj, f.name, f.default_factory())
            elif f.default is not dataclasses.MISSING \
                    and f.default is not None:
                setattr(obj, f.name, f.default)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            normalize_nones(v)
        elif isinstance(v, list):
            v[:] = [normalize_nones(item) for item in v if item is not None]
        elif isinstance(v, dict):
            drop = [k for k, item in v.items() if item is None]
            for k in drop:
                del v[k]
            for item in v.values():
                normalize_nones(item)
    return obj
