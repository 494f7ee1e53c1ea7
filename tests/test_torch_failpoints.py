"""The port's failpoints (`swarmkit_tpu_torch/utils/failpoints.py`) and lock
factory (`swarmkit_tpu_torch/analysis/lockgraph.py`): the inert disarmed
site, arming with times/skip/every, the error kinds, and the
environment-variable arming (after the JAX package's
tests/test_failpoints.py)."""
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from swarmkit_tpu_torch.analysis import lockgraph
from swarmkit_tpu_torch.utils import failpoints

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    failpoints.disarm_all()


def test_disarmed_site_is_inert():
    failpoints.fp("never.armed")
    assert failpoints.active() == []
    assert failpoints._ARMED == {}


def test_armed_error_times_and_counters():
    with failpoints.armed("a.b", error=ValueError("boom"), times=2) as p:
        for _ in range(2):
            with pytest.raises(ValueError, match="boom"):
                failpoints.fp("a.b")
        failpoints.fp("a.b")          # exhausted: a no-op
        assert (p.evaluated, p.fired) == (3, 2)
        assert failpoints.active() == ["a.b"]
    assert failpoints.active() == []  # the context manager disarmed


def test_skip_and_every():
    with failpoints.armed("a.c", error=RuntimeError, skip=2, every=2) as p:
        fired = []
        for _ in range(8):
            try:
                failpoints.fp("a.c")
                fired.append(False)
            except RuntimeError:
                fired.append(True)
        # skips 2 evaluations, then fires every 2nd of the rest
        assert fired == [False, False, False, True, False, True, False,
                         True]
        assert p.fired == 3


def test_error_kinds():
    with failpoints.armed("a.e", error=True):
        with pytest.raises(failpoints.FailpointError):
            failpoints.fp("a.e")
    with failpoints.armed("a.f", error=lambda: OSError(5, "io")):
        with pytest.raises(OSError) as exc:
            failpoints.fp("a.f")
        assert exc.value.errno == 5
    failpoints.arm("a.g", error=KeyError)
    failpoints.disarm("a.g")
    failpoints.fp("a.g")


def test_env_var_arming_roundtrip():
    failpoints._parse_env(
        "x.env=error:oserror,times:1; y.env=error,skip:1,every:2;"
        "z.env=error:runtimeerror:custom msg")
    assert set(failpoints.active()) == {"x.env", "y.env", "z.env"}
    with pytest.raises(OSError):
        failpoints.fp("x.env")
    failpoints.fp("x.env")            # times:1 exhausted
    failpoints.fp("y.env")            # skip:1
    failpoints.fp("y.env")            # every:2, first of the pair
    with pytest.raises(failpoints.FailpointError):
        failpoints.fp("y.env")
    with pytest.raises(RuntimeError, match="custom msg"):
        failpoints.fp("z.env")
    failpoints.disarm_all()
    assert failpoints.active() == []


def test_env_var_arms_a_subprocess():
    code = ("from swarmkit_tpu_torch.utils import failpoints\n"
            "print(failpoints.active())\n"
            "try:\n"
            "    failpoints.fp('commit.walk')\n"
            "except RuntimeError as e:\n"
            "    print('raised', e)\n")
    env = {**os.environ,
           "SWARMKIT_TPU_TORCH_FAILPOINTS": "commit.walk=error:runtimeerror:x"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.stdout.split("\n")[:2] == ["['commit.walk']", "raised x"], \
        res.stderr


def test_lock_factory_is_plain():
    assert type(lockgraph.make_lock("x")) is type(threading.Lock())
    assert type(lockgraph.make_rlock("y")) is type(threading.RLock())
