"""Build and bind the port's CUDA kernels (`swarmkit_tpu_torch/csrc/*.cu`).

Each kernel source compiles with `nvcc` for sm_90a into its own shared
library with a plain C interface, and loads with ctypes. The build happens
at first use, into `build/torch_kernels/` at the repository root (listed in
.gitignore), and again whenever a source or a shared header is newer than
its library. `build()` starts one nvcc per stale source, all together.

A failed build raises; so does a C entry that returns a CUDA error. There is
no fallback to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int

# library name -> {C entry: argtypes}; every entry returns a cudaError_t
ENTRIES = {
    "static_mask": {
        "skt_static_mask": [_P] * 10 + [_I] * 8 + [_P],
        "skt_sharded_static_mask": [_P] * 6 + [_I] * 9 + [_P],
    },
    "flat_fill": {
        "skt_flat_fill_step": [_P] * 15 + [_I] * 4 + [_P],
        "skt_flat_fill_scratch_i32": [_I],
        "skt_flat_fill_plan": [_I, _P],
    },
    "tree_fill": {
        "skt_tree_fill_step": [_P] * 17 + [_I] * 5 + [_P],
        "skt_tree_fill_scratch_i32": [_I, _I],
        "skt_tree_fill_plan": [_I, _I, _P],
    },
    "replay_commit": {
        "skt_replay_commit": [_P] * 4 + [_I] * 2 + [_P],
    },
    "resident_delta_scatter": {
        "skt_resident_delta_scatter": [_P] * 17 + [_I] * 7 + [_P],
    },
    "counts_window": {
        "skt_counts_window": [_P] * 2 + [_I] * 4 + [_P],
        "skt_counts_window_vec4": [_P] * 2 + [_I] * 4 + [_P],
    },
    "sparse_counts": {
        "skt_sparse_counts": [_P] * 4 + [_I] * 5 + [_P],
        "skt_sparse_counts_tile": [],
    },
    "svc_matrix_build": {
        "skt_svc_matrix_build": [_P] * 3 + [ctypes.c_longlong, _I, _P],
    },
    "binpack_fill": {
        "skt_binpack_fill_step": [_P] * 15 + [_I] * 4 + [_P],
        "skt_binpack_fill_scratch_i32": [_I],
        "skt_binpack_fill_plan": [_I, _P],
    },
    "unpack_bits": {
        "skt_unpack_bits": [_P] * 2 + [_I] * 3 + [_P],
    },
    "frontier_advance": {
        "skt_frontier_advance_burst": [_P] * 5 + [_I] * 3 + [_P],
    },
    "match_index_commit": {
        "skt_match_index_commit": [_P] * 3 + [_I, _P],
        "skt_match_index_commit_at": [_P, _I, _P, _I, _P],
    },
    "replay_log_scan": {
        "skt_replay_log_scan": [_P] * 3 + [_I] * 3 + [_P],
    },
    "global_diff": {
        "skt_global_diff": [_P] * 7 + [_I] * 4 + [_P],
    },
    "diff_compact": {
        "skt_diff_compact": [_P] * 4 + [_I] * 3 + [_P],
        "skt_diff_compact_tile": [],
    },
    "task_count_flat": {
        "skt_task_count_flat": [_P] * 2 + [_I] * 3 + [_P],
    },
    "churn_burst": {
        "skt_churn_burst": [_P] * 9 + [_I] * 5 + [_P],
    },
    "grant_order": {
        "skt_grant_order": [_P] * 4 + [_I] * 3 + [_P],
        "skt_grant_order_tile": [],
    },
    "replica_slot_state": {
        "skt_replica_slot_state": [_P] * 8 + [_I] * 3 + [_P],
    },
    "sharded_water_fill": {
        "skt_sharded_water_fill_step": [_P] * 12 + [_I] * 7 + [_P],
        "skt_sharded_water_fill_scratch": [_I] * 4,
        "skt_sharded_water_fill_max_shards": [],
        "skt_sharded_water_fill_plan": [_I] * 3 + [_P],
    },
    "sharded_binpack_fill": {
        "skt_sharded_binpack_fill_step": [_P] * 9 + [_I] * 5 + [_P],
        "skt_sharded_binpack_fill_scratch_i32": [_I, _I],
        "skt_sharded_binpack_fill_max_shards": [],
        "skt_sharded_binpack_fill_plan": [_I, _I, _P],
    },
    "sharded_replay_tally": {
        "skt_sharded_replay_tally": [_P] * 6 + [_I] * 4 + [_P],
    },
    "sharded_delta_scatter": {
        "skt_sharded_delta_scatter": [_P] * 10 + [_I] * 8 + [_P],
    },
    "sharded_counts_pull": {
        "skt_sharded_counts_dense": [_P] * 2 + [_I] * 5 + [_P],
        "skt_sharded_counts_dense_vec4": [_P] * 2 + [_I] * 5 + [_P],
        "skt_sharded_counts_sparse": [_P] * 4 + [_I] * 6 + [_P],
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_tables: dict = {}


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"libskt_{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime
                 for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return newest > lib.stat().st_mtime


def build(names=None) -> dict[str, tuple[float, str]]:
    """Compile the stale libraries among `names` (default: all), one nvcc
    process each, all started together. Returns {name: (seconds, nvcc
    output)} for what was built; raises KernelBuildError on any failure."""
    names = list(ENTRIES) if names is None else list(names)
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f".libskt_{n}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out, failed = {}, []
    for n, (tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, library_path(n))   # atomic: readers never see half
        out[n] = (time.perf_counter() - t0, log)
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    return out


def lib(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if stale."""
    with _lock:
        cdll = _loaded.get(name)
        if cdll is None:
            build([name])
            cdll = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in ENTRIES[name].items():
                f = getattr(cdll, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _loaded[name] = cdll
        return cdll


def route(what: str, *tensors) -> str:
    """The route of a wrapper's call: "plain" for CPU tensors, "kernel"
    for CUDA ones; tensors on two devices, or on any other device, raise
    (no kernel, no fallback)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return "plain"
    if dev.type != "cuda":
        raise ValueError(f"no {what} kernel for device {dev}")
    return "kernel"


def check(rc: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error (a refused launch)."""
    if rc != 0:
        raise KernelLaunchError(f"{what}: CUDA error {rc} at launch")


def stream_of(t) -> int:
    """The handle of PyTorch's current stream on t's device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def raw_stream(t) -> int:
    """The handle of PyTorch's current stream on t's device, as `stream_of`
    gives it, read without building a `torch.cuda.Stream` object (the
    cheaper call, for wrappers whose launch costs less than that object)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def pointer_table(ptrs, device):
    """A device table int64[...] of raw pointers (the sharded kernels'
    per-shard rows), on `device`. A launch loop passes the same tensors
    step after step, so the last few tables are kept by their pointers:
    each is uploaded once, and a call that finds its table kept copies
    nothing (so it can be captured in a CUDA graph)."""
    import torch

    key = (str(device), tuple(map(tuple, ptrs)))
    table = _tables.get(key)
    if table is None:
        if len(_tables) >= 8:
            _tables.clear()
        table = torch.tensor(ptrs, dtype=torch.int64).to(device)
        _tables[key] = table
    return table
