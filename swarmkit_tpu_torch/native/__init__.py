"""Native host-runtime loops (C, built with the system compiler at first use).

The device work is the CUDA kernels under `csrc/`; the host runtime around
it is Python, with C for the measured hot loops (`_hostops.c`): the commit
walk that books a wave's placements onto the NodeInfo tables
(`apply_segments`, `apply_wave`) and the object model's deep copy
(`tree_copy`). The walk releases the GIL between node segments, which is
what lets the async commit plane (`ops/commit.py`) overlap the wave loop.

`load()` builds the module on its first call with one `cc -O2 -shared`
against the CPython headers (no pip, no setuptools) into `build/native/`
at the repository root (listed in .gitignore), never beside the source,
and again whenever the source is newer than the library. Concurrent
processes race safely: each compiles to a unique temporary file and
renames it into place atomically. Without a compiler or the headers,
`load()` returns None and every caller takes its pure-Python path, which
stays the reference oracle.
"""
from __future__ import annotations

import importlib.util
import logging
import os
import shutil
import subprocess
import sysconfig
import tempfile
import threading
from importlib.machinery import ExtensionFileLoader
from pathlib import Path

log = logging.getLogger("swarmkit_tpu_torch.native")

SRC = Path(__file__).resolve().parent / "_hostops.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# the interpreter's ABI tag in the name: a library built for another
# Python never shadows this one's
LIB = BUILD_DIR / ("_hostops" + (sysconfig.get_config_var("EXT_SUFFIX")
                                 or ".so"))
MODULE = "swarmkit_tpu_torch.native._hostops"

_lock = threading.Lock()
_UNSET = object()
_mod = _UNSET


def build() -> bool:
    """Compile SRC into LIB; False (logged) when no compiler or a failure."""
    cc = next((c for c in ("cc", "gcc", "clang") if shutil.which(c)), None)
    if cc is None:
        log.warning("native: no C compiler; using the pure-Python walks")
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cc, "-O2", "-fPIC", "-shared", "-I",
           sysconfig.get_paths()["include"], str(SRC), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
        if proc.returncode != 0:
            log.warning("native: build failed; using the pure-Python "
                        "walks\n%s", proc.stderr[-2000:])
            return False
        os.replace(tmp, LIB)     # atomic: parallel builds race safely
        return True
    except (OSError, subprocess.SubprocessError) as exc:
        log.warning("native: build error (%s); using the pure-Python walks",
                    exc)
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _exec():
    loader = ExtensionFileLoader(MODULE, str(LIB))
    spec = importlib.util.spec_from_loader(MODULE, loader, origin=str(LIB))
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod


def _load():
    fresh = LIB.exists() and LIB.stat().st_mtime >= SRC.stat().st_mtime
    if not fresh and not build():
        return None
    try:
        return _exec()
    except ImportError:
        # e.g. a library another build left half-compatible: rebuild once
        if not build():
            return None
        try:
            return _exec()
        except ImportError as exc:
            log.warning("native: load failed (%s); using the pure-Python "
                        "walks", exc)
            return None


def load():
    """The `_hostops` module, built at first use; None when it cannot be
    built or loaded (the callers then take their pure-Python paths)."""
    global _mod
    if _mod is _UNSET:
        with _lock:
            if _mod is _UNSET:
                _mod = _load()
    return _mod
