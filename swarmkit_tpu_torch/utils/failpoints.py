"""Deterministic fault injection: named failpoints (the port's copy of the
JAX package's `utils/failpoints.py`, cut down to the raising sites).

A failpoint is a named site in production code,

    failpoints.fp("commit.walk")

which, disarmed, costs one module-global truthiness test: no allocation,
no lock. Armed (per test through `armed()`, or for a subprocess through
the SWARMKIT_TPU_TORCH_FAILPOINTS environment variable), a site raises a
chosen exception (an instance, a class or a factory), and fires only the
first N times (`times=`), after K clean passes (`skip=`), or every Nth
evaluation (`every=`).

Site names follow `<layer>.<component>.<operation>`. Sites sit at the
boundaries where an error changes what state survives, never inside a
per-entry loop.

Arming replaces the registry dict wholesale (copy on write), so a firing
thread never takes the registry lock; each armed failpoint keeps its
counters under a private lock.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Any

from ..analysis.lockgraph import make_lock

_REG_LOCK = make_lock("utils.failpoints.REG_LOCK")
# name -> _Failpoint; REPLACED wholesale on arm/disarm, read without a lock.
# Empty when nothing is armed: the disarmed path is `if not _ARMED`.
_ARMED: dict[str, "_Failpoint"] = {}


class FailpointError(Exception):
    """The injected error when a site is armed with error=True."""


def _make_exc(spec) -> BaseException:
    """A fresh exception per fire (re-raising one instance would chain
    tracebacks across fires)."""
    if spec is True:
        return FailpointError("injected failure")
    if isinstance(spec, BaseException):
        if isinstance(spec, OSError) and spec.errno is not None:
            return type(spec)(spec.errno, spec.strerror or str(spec))
        return type(spec)(*spec.args) if spec.args else type(spec)(str(spec))
    if isinstance(spec, type) and issubclass(spec, BaseException):
        return spec("injected failure")
    if callable(spec):
        return spec()
    raise TypeError(f"bad error spec for failpoint: {spec!r}")


class _Failpoint:
    """One armed site. The counters change under a private lock; the
    raise happens outside it."""

    def __init__(self, name: str, *, error: Any = None,
                 times: int | None = None, skip: int = 0,
                 every: int | None = None):
        self.name = name
        self.error = error
        self.times = times
        self.skip = skip
        self.every = every
        self.evaluated = 0          # site reached while armed
        self.fired = 0              # action actually taken
        self._lock = make_lock("utils.failpoints.counters")

    def _should_fire(self) -> bool:
        with self._lock:
            self.evaluated += 1
            if self.times is not None and self.fired >= self.times:
                return False
            if self.evaluated <= self.skip:
                return False
            if self.every is not None \
                    and (self.evaluated - self.skip) % self.every != 0:
                return False
            self.fired += 1
            return True

    def trigger(self):
        if self._should_fire() and self.error is not None:
            raise _make_exc(self.error)


def fp(name: str) -> None:
    """Injection site: a no-op unless `name` is armed; may raise."""
    if not _ARMED:
        return
    p = _ARMED.get(name)
    if p is not None:
        p.trigger()


def arm(name: str, **kw) -> _Failpoint:
    """Arm `name`; returns the failpoint (its `fired`/`evaluated` counters
    are for tests). Re-arming replaces the previous configuration."""
    p = _Failpoint(name, **kw)
    with _REG_LOCK:
        new = dict(_ARMED)
        new[name] = p
        _set_registry(new)
    return p


def disarm(name: str) -> None:
    with _REG_LOCK:
        if name in _ARMED:
            new = dict(_ARMED)
            new.pop(name, None)
            _set_registry(new)


def disarm_all() -> None:
    with _REG_LOCK:
        _set_registry({})


def active() -> list[str]:
    return sorted(_ARMED)


def _set_registry(new: dict) -> None:
    global _ARMED
    _ARMED = new


@contextmanager
def armed(name: str, **kw):
    """`with failpoints.armed("commit.walk", error=RuntimeError): ...`;
    always disarms on exit."""
    p = arm(name, **kw)
    try:
        yield p
    finally:
        disarm(name)


# SWARMKIT_TPU_TORCH_FAILPOINTS arms sites in a subprocess, where a context
# manager cannot reach:
#   name=error:runtimeerror:msg;name2=error:oserror,times:1,skip:2
_ENV_VAR = "SWARMKIT_TPU_TORCH_FAILPOINTS"

_ENV_ERRORS = {
    "oserror": OSError,
    "connectionreset": ConnectionResetError,
    "timeout": TimeoutError,
    "valueerror": ValueError,
    "runtimeerror": RuntimeError,
    "failpoint": FailpointError,
}


def _parse_env(spec: str) -> None:
    for item in spec.split(";"):
        item = item.strip()
        if not item or "=" not in item:
            continue
        name, actions = item.split("=", 1)
        kw: dict[str, Any] = {}
        for action in actions.split(","):
            parts = action.split(":")
            kind = parts[0].strip().lower()
            if kind == "error":
                exc = _ENV_ERRORS.get(
                    parts[1].strip().lower() if len(parts) > 1 else "",
                    FailpointError)
                if len(parts) > 2:
                    kw["error"] = (lambda e=exc, m=parts[2]: e(m))
                else:
                    kw["error"] = exc
            elif kind == "times":
                kw["times"] = int(parts[1])
            elif kind == "skip":
                kw["skip"] = int(parts[1])
            elif kind == "every":
                kw["every"] = int(parts[1])
        if kw:
            arm(name.strip(), **kw)


if os.environ.get(_ENV_VAR):
    _parse_env(os.environ[_ENV_VAR])
