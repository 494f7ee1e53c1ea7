"""swarmkit_tpu_torch: the PyTorch/CUDA port of `swarmkit_tpu`.

The port runs the scheduler's placement wave (spread, topology and
binpack), its steady tick on device-resident node state (`ops/resident.py`,
`ops/pipeline.py`, with the async commit plane of `ops/commit.py`), the
flagship cluster step, the raft replay burst (`ops/raft_replay.py`) and the
global orchestrator's reconcile over its own store (`store/`,
`orchestrator/global_.py` on `ops/reconcile.py`, with the device-resident
O(churn) diff) and the allocator plane that moves new tasks to PENDING
(`allocator/`: IPAM, published ports, whole NEW batches through
`ops/alloc.py` grants, the deallocator), the replicated orchestrator's
reconcile (`orchestrator/replicated.py`, `orchestrator/batched.py`) and the
one-shot mesh path as a k-way node split of the card (`parallel/`) on one
NVIDIA H100. Host code (the object model, the store, the orchestrators,
the allocator, the encoder, the CPU oracles) is numpy/Python, as in the JAX
package, with the commit walk and the deep copy in C (`native/`); the
device work is twenty-two CUDA C++ kernels for sm_90a under `csrc/`
(K1-K22), each with its plain PyTorch version beside its wrapper in `ops/`
or `parallel/`.

Entry points run on the card unless the caller passes `device="cpu"`; with
no device given and no CUDA device present they raise. A kernel wrapper
runs the plain version only for tensors that lie on the CPU.

The port imports neither JAX nor the JAX package; it keeps its own copy of
what it needs (`api/`, `scheduler/`, `store/`, `state/`, `orchestrator/`,
`allocator/`, `native/`, `utils/`, the exceptions of `raft/`,
`analysis/lockgraph.py`).
"""
