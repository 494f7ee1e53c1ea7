"""Canonical service-spec defaults.

Re-derivation of api/defaults/service.go:13+. Unlike the reference's protos
(where unset submessages arrive nil and are merged over a canonical default
spec), our dataclasses bake the same canonical values into their field
defaults — RestartPolicy(condition=ANY, delay=5s), UpdateConfig(
parallelism=1, failure_action=PAUSE) — so a freshly-constructed spec is
already canonical. This module holds the one genuinely-optional merge
(rollback config) plus the canonical constructors, so control-API validation
has a single source of truth to cite.

The port's copy of the JAX package's `api/defaults.py`.
"""
from __future__ import annotations

from .specs import RestartPolicy, ServiceSpec, UpdateConfig
from .types import RestartCondition, UpdateFailureAction

DEFAULT_RESTART_DELAY = 5.0  # defaults/service.go RestartPolicy.Delay 5s
DEFAULT_UPDATE_PARALLELISM = 1


def default_restart_policy() -> RestartPolicy:
    return RestartPolicy(condition=RestartCondition.ANY, delay=DEFAULT_RESTART_DELAY)


def default_update_config() -> UpdateConfig:
    return UpdateConfig(
        parallelism=DEFAULT_UPDATE_PARALLELISM,
        failure_action=UpdateFailureAction.PAUSE,
    )


def merge_service_defaults(spec: ServiceSpec) -> ServiceSpec:
    """Fill genuinely-optional fields in place (defaults/service.go Service
    merge). Restart and update configs are non-optional dataclass fields
    whose defaults already carry the canonical values; rollback is the one
    Optional field to fill. Returns the spec."""
    if spec.rollback is None:
        spec.rollback = default_update_config()
    return spec
