"""Chip smoke test of the PyTorch/CUDA port (`swarmkit_tpu_torch`).

Drives the port's main paths on one CUDA card and fails (exit code != 0, no
result line) if any phase fails:

  1. device   — the card's name, count and power limit;
  2. build    — nvcc builds the 24 kernels from csrc/, all at once, and
                cc the native commit walk (native/_hostops.c); the run
                fails unless the native module loaded;
  3. kernels  — K1-K4 and K9 against their plain PyTorch versions on the
                card, at the main path's shapes (10,000 nodes, 20 groups,
                K9 on the grid problem encoded for binpack; a 5 x 2^20 raft
                log), exactly equal; times by CUDA events (K1 also from a
                CUDA graph and by the host clock; K2, K3 and K9 also from
                a CUDA graph, with their launch: cluster size,
                shared memory, routes, and ptxas' registers, stack and
                spills; K9 with its key route on the inputs);
  4. waves    — three scheduler waves of 100,000 tasks (20 services x 5,000)
                onto 10,000 nodes: encode -> device_schedule_encoded ->
                materialize_orders -> apply_wave (the native walk), each
                wave's counts equal to the CPU oracle's;
  5. flagship — entry()'s cluster step at 10,000 nodes x 20 groups x 5,000
                tasks over a 2^20-entry, 5-manager log: counts and totals
                equal to the CPU oracle, commit index equal to a numpy tally;
  6. binpack  — phases 4 and 5 under the binpack strategy: three grid waves
                encoded for binpack, and cluster_step(strategy=1) on the
                flagship cluster encoded for binpack, against the oracle;
  7. native walk — one grid wave's apply_wave through the C walk and
                through the pure-Python walk on two copies of the nodes:
                every NodeInfo equal, field for field; both host times;
  8. steady   — the device-resident tick (ResidentPlacement) with
                TickPipeline(depth=3, async_commit=True): a cold tick and 8
                pipelined waves on the grid (10,000 nodes, 20 x 5,000 tasks
                a wave: dense counts pulls), the same grid run again with
                the synchronous commit (equal counts wave for wave, equal
                NodeInfos after the flush), a binpack grid run (K9 in the
                resident tick), and a node-heavy cluster (100,000 nodes,
                20 x 500 tasks a wave: sparse pulls), with task completions
                (delta rows) and one invalidate() (a cold re-upload) in
                each; then 3 resident ticks of the flagship cluster (tree
                fill, LMAX 3 padded to 4 levels). Every wave's counts equal
                the CPU oracle on its completed problem, and the carry its
                dispatch left on the card equals the kernels' expected
                fold (service matrix included); all three svc-matrix upload
                branches and both pull forms are taken;
  9. resident kernels — K1-K3 and K9 against their plain versions on the
                first steady wave of each configuration (the resident
                shapes: nodes padded to 16,384 and 131,072, LMAX 3 padded to
                4, the group tables as row views; K2, K3 and K9 also from
                a CUDA graph, with their launch), and K5-K8 on inputs
                recorded from phase 8; times by CUDA events, and for K5-K8
                also the device time alone (their calls replayed from a
                CUDA graph); K6 in turns with its library call (the slice
                and cast), K8 in turns with its library calls (zeros +
                scatter_add_ for the sparse build, zeros for the all-zero
                one), by CUDA events and by the host clock.
 10. replay   — the raft replay burst at bench.py's shape (5 managers x
                1,000,000 entries, bench.py:580-660): the cold bit-packed
                upload unpacked on the card (K10), replay_commit (K4), 4
                bursts of 16 frontier advances on the resident matrix (K11)
                and one single advance, match_index_commit (K12) on every
                round's frontiers, and the streaming replay_log_scan (K13,
                chunk 65,536) on that matrix and on the flagship's 5 x 2^20
                log: every commit, and the final matrix, equal to numpy;
                then K10-K13 against their plain versions on those inputs
                (K12 with its quorum an int and a CUDA tensor, in turns
                with torch.kthvalue, and from a CUDA graph);
 11. int32    — two ticks past the old N * max(n_tasks) >= 2^31 guard whose
                capacity sums stay far below 2^31 (the steps now flag a
                group only when its sum reaches 2^31): a resident tick at
                65,537 nodes (131,072 on the card) with a 16,384-task
                service and the one-shot entry at 20,000 nodes with a
                131,072-task service, each placing every task, equal to the
                CPU oracle;
 12. global   — a new leader's startup reconcile of the global services
                over the store: 50,000 READY nodes in 20 zones, 20 global
                services pinned to one zone each, one RUNNING task per
                eligible pair, then 1% of the nodes drained, 1% down and 1%
                added (20 x 50,500 = 1.01 M cells, at DIFF_THRESHOLD or
                above). store.view_and_watch(orch.setup), then
                orch.on_start: check_tasks (restarts armed on the real
                clock), then bulk_reconcile (host scan, two K14 diffs
                through compute_diff, one store batch); each diff equal to
                numpy and the plain version, the scan's eligibility equal
                to a plain reference, every eligible pair then carrying a
                runnable task and no drained or down node any; then one
                start()/stop() of the event loop, whose startup pass plans
                nothing; scan, diff and apply seconds apart;
 13. reconcile — the device-resident O(churn) diff at bench.py's
                global-diff row (bench.py:463-578: 200 services x 50,000
                nodes, 2,000 task slots, default_rng(0), converged start):
                the cold packed upload (K10) and count (K16), 6 bursts of
                16 rounds of 1% churn (K17) from the same carry, every
                round's codes equal to the numpy full diff at its touched
                pairs, the burst's carries equal to numpy and K16; round 16
                again through global_diff_update (K14) and
                global_diff_update_compact (cap 2U, K14 + K15) on the state
                after round 15, equal to numpy; then K14-K17 against their
                plain versions on the inputs of phases 12 and 13 (times by
                CUDA events; torch.nonzero and torch.bincount as the
                library times of K15 and K16);
 14. alloc    — the allocator plane: a new leader's startup allocation for
                a global service on an overlay network with a /16 subnet
                (65,536 addresses; `docker network create --driver overlay
                --subnet 10.0.0.0/16`) over 50,000 READY nodes. The global
                orchestrator's startup pass creates 50,000 NEW tasks; the
                allocator's event loop (view_and_watch(setup), on_start)
                gives the network its pool, the service its VIP and the
                tasks their addresses in 250 chunks of 200, one K19
                grant each over the 65,533-address probe range; then round
                2 on the live loop, one store transaction: 1% of the nodes
                drained with their tasks shut down, 1% new nodes with a
                NEW task each, which the first release retries in
                batches. The same scenario runs again with the plain
                version (device="cpu") and with the scalar IPAM and
                PortAllocator (the per-task loop): every task PENDING or
                terminal, no address held twice, every address, the
                pool's cursor and its allocated set equal across the three
                runs, and the global orchestrator's pass over the result
                plans nothing; host seconds of the store build, the
                orchestrator pass, the allocator's rebuild, the grants and
                the store batches, and the card's idle share; then K19
                against its plain version on three recorded startup chunks
                and on a 2^20-address pool at 50% occupancy (cursor in the
                middle, cursor past the range), with torch.argsort(stable)
                as its library time.
 15. replicated — the replicated services' reconcile path at bench.py's
                orchestrator-storm row (bench.py:2288: 100,000 services of
                2 replicas, a storm of 300 x 5), with 1,000 of the
                services at 10 replicas (slots 1-10: a census of 100,000 x
                11 = 1.1 M cells), 208,000 RUNNING tasks on 10,000 nodes;
                the drift a new leader inherits: 100 services scaled up by
                2, 100 down by 1, 1% of the tasks FAILED. A
                ReplicatedOrchestrator's start(): on_start runs check_tasks
                and one batched reconcile whose census runs on K18, its
                decisions equal to decide_many with device="cpu" and to
                the scalar decide_service (every decided service and 1,000
                sampled steady ones); a store-side agent pump driven by the
                watch queue converges the store (every service its
                replicas in distinct runnable slots, no slot with two tasks
                desired RUNNING); 100 nodes DOWN in one transaction reach
                restart_many, whose grants equal sequential should_restart
                calls; 300 services x 5 pushed to v2 in one batch, 25%
                poisoned with failure_action=rollback, converge on one
                planner thread (rolled back to v1, or completed on v2)
                within 120 s; a second leader's on_start on the converged
                store (K18 again) plans nothing; the columnar mirror equals
                a rebuild. Host seconds of each part, the census's upload,
                K18 and download apart, and the card's busy share of
                on_start; then K18 against its plain version on both
                recorded censuses and on a 2^20 x 16 census.
 16. mesh     — the one-shot mesh path as a k-way node split of the card
                (__graft_entry__.dryrun_multichip's stages): sharded
                placement of random-cluster-shaped and example problems at
                35 nodes for k = 1, 2, 8 under spread, topology and binpack,
                equal to the CPU oracle and the one-device counts; the
                manager-axis tally (K22) at 8 x 2,048 and 8 x 2^20 against
                numpy; the north-star fused step (example_cluster(10,245,
                101, 990): LMAX 3, ports, generic resources; a 5 x 2^15 log)
                against the oracle and the sorted-frontier rule; the
                scale-out fused step (synth_shard_cluster: 131,072 nodes,
                16 groups, 1,048,576 tasks) under spread, binpack and
                topology, its commit equal to replay_commit, its counts at
                8 shards equal to 1 shard and to the one-device
                cluster_step, the invariant sweep and the sampled-shard
                oracle on 2 shards (8 shards twice: the first call of
                the shapes, then again); K1 runs once over the 8 shards
                (sharded_static_mask). Then K20-K22 against their plain
                versions on the scale-out inputs (CUDA events and a CUDA
                graph; K20 and K21 also by the host clock, with their
                launch, K21 with its key route), the sharded K1 at 8 x
                16,384 x 16 (events, graph, host clock, beside the
                per-shard route of 8 one-device calls), and K3 and K9 on
                the scale-out
                spread and binpack problems as the one-device cluster_step
                runs them (131,072 nodes, spread LMAX 2; CUDA events, a
                CUDA graph, the launch).
 17. mesh_resident — the resident tick with its carry node-sharded over 8
                shards of the card (MeshResidentPlacement under
                TickPipeline): phase 8's grid (10,000 nodes, 20 x 5,000
                tasks a wave, dense pulls) and node-heavy (100,000 nodes in
                8 shards of 16,384, 20 x 500 tasks a wave, sparse pulls)
                runs, each with the async and then the synchronous commit:
                a cold tick and 8 pipelined waves, task completions on 32
                nodes before wave 7 (K23 delta rows), invalidate() before
                wave 8 (a cold re-upload, K8 a shard). Every wave's counts,
                the NodeInfos after the flush and the joined carry equal
                the one-device tick's run of phase 8; both pull forms of
                K24 are taken; then K23 and K24 against their plain
                versions on the phase's recorded inputs (CUDA events and a
                CUDA graph; K24 in turns with torch.cat + cast and
                torch.nonzero_static + gather, by CUDA events and by the
                host clock), K20 against its plain version on the grid's
                recorded cold-tick fill (8 x 2,048: CUDA events a step and
                a CUDA graph), and the sharded K1 on that tick's recorded
                mask inputs (8 x 2,048 x 20, as at [mesh]). K1 must launch
                once a tick (36 ticks).

Each path (phases 4-5, phase 6, phase 8, phase 10, 11, 12, 13, 14, 15, 16
and 17) runs with every launch count set to 0 just before it, and fails
unless each of its kernels launched.

Run from the repository root: `python3 chip_smoke.py [--seed N]`. The last
line of its output is {"ok": true, "device": {...}}. `--mask-only` times
K1 alone and stops (see `mask_only`).
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import gc
import json
import random
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores

N_NODES = 10_000
N_GROUPS = 20
TASKS_PER_GROUP = 5_000
N_MANAGERS = 5
LOG_LEN = 1 << 20
N_WAVES = 3
STEADY_WAVES = 8             # pipelined waves after each cold tick
HEAVY_NODES = 100_000        # node-heavy steady configuration
HEAVY_PER_SERVICE = 500
FLAGSHIP_TICKS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device ms per call of fn over `iters` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, nops: int) -> tuple[float, str]:
    """Least time in ms for the work: bytes over the memory rate, or
    operations over the ALU rate, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / ALU_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ------------------------------------------------------------- generators
LABEL_KEYS = ["zone", "disk", "tier"]
LABEL_VALS = ["a", "b", "c", "ssd", "hdd"]


def grid_nodes(rng, n_nodes):
    """READY, ACTIVE nodes with random labels, platforms and resources (the
    node generator of the repository's grid benchmark)."""
    from swarmkit_tpu_torch.api.objects import Node
    from swarmkit_tpu_torch.api.specs import (
        Annotations,
        NodeDescription,
        Platform,
        Resources,
    )
    from swarmkit_tpu_torch.api.types import NodeAvailability, NodeStatusState
    from swarmkit_tpu_torch.scheduler.encode import CPU_QUANTUM, MEM_QUANTUM
    from swarmkit_tpu_torch.scheduler.nodeinfo import NodeInfo

    infos = []
    for i in range(n_nodes):
        n = Node(id=f"node-{i:05d}")
        rng.random()        # the state draw; every node is READY here
        n.status.state = NodeStatusState.READY
        n.status.addr = f"10.0.{i % 256}.{(i * 7) % 256}"
        rng.random()        # the availability draw; every node is ACTIVE
        n.spec.availability = NodeAvailability.ACTIVE
        n.spec.annotations = Annotations(name=f"node-{i}", labels={
            k: rng.choice(LABEL_VALS) for k in LABEL_KEYS
            if rng.random() < 0.7})
        n.description = NodeDescription(
            hostname=f"host-{i}",
            platform=Platform(os=rng.choice(["linux", "windows"]),
                              architecture=rng.choice(["x86_64", "amd64",
                                                       "arm64"])),
            resources=Resources(
                nano_cpus=rng.randint(1, 16) * CPU_QUANTUM * 1000,
                memory_bytes=rng.randint(1, 64) * MEM_QUANTUM * 1024),
            plugins=[("Volume", "local"), ("Network", "overlay")]
            + ([("Volume", "nfs")] if rng.random() < 0.5 else []))
        infos.append(NodeInfo.new(n, {}, n.description.resources.copy()))
    return infos


def grid_groups(wave, n_services=N_GROUPS, per_service=TASKS_PER_GROUP):
    """20 services x 5,000 pending tasks, no spread preferences (the flat
    fill): reservations by service index, a zone constraint on every third
    service."""
    from swarmkit_tpu_torch.api.objects import Task
    from swarmkit_tpu_torch.api.specs import Placement
    from swarmkit_tpu_torch.api.types import TaskState
    from swarmkit_tpu_torch.scheduler.encode import (
        CPU_QUANTUM,
        MEM_QUANTUM,
        TaskGroup,
    )

    groups = []
    for gi in range(n_services):
        svc = f"svc-{gi:03d}"
        tasks, spec = [], None
        for ti in range(per_service):
            t = Task(id=f"task-w{wave}-{gi:03d}-{ti:06d}", service_id=svc,
                     slot=ti + 1)
            t.desired_state = TaskState.RUNNING
            t.status.state = TaskState.PENDING
            if spec is None:
                spec = t.spec
                spec.resources.reservations.nano_cpus = (gi % 3) * CPU_QUANTUM
                spec.resources.reservations.memory_bytes = \
                    (gi % 4) * MEM_QUANTUM
                if gi % 3 == 0:
                    spec.placement = Placement(
                        constraints=[f"node.labels.zone == {'ab'[gi % 2]}"])
            else:
                t.spec = spec
            tasks.append(t)
        groups.append(TaskGroup(service_id=svc, spec_version=wave + 1,
                                tasks=tasks, ids=[t.id for t in tasks]))
    return groups


# ---------------------------------------------------------------- phases
def phase_device() -> tuple[str, int]:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    log(f"[device] {name} x{count} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi.stdout.strip().splitlines()[0])   # name, power limit
    return name, count


def phase_build():
    import threading

    from swarmkit_tpu_torch import native
    from swarmkit_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    # cc builds the native walk while nvcc builds the kernels
    box = {}
    cc = threading.Thread(target=lambda: box.update(
        mod=native.load(), s=time.perf_counter() - t0))
    cc.start()
    built = _kernels.build()
    for name, (sec, out) in built.items():
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        log(f"[build] {name}: {sec:.2f} s; {'; '.join(regs)}")
        PTXAS[name] = "; ".join(
            ln.strip().replace("ptxas info    : ", "")
            for ln in out.splitlines()
            if "registers" in ln or "stack frame" in ln)
    for name in _kernels.ENTRIES:
        _kernels.lib(name)
    cc.join()
    if box.get("mod") is None:
        fail("the native commit walk (native/_hostops.c) did not build or "
             "load")
    log(f"[build] {len(built)} kernel libraries built in "
        f"{time.perf_counter() - t0:.2f} s (wall); native walk "
        f"{native.LIB.name} loaded after {box['s']:.2f} s")


# ptxas' registers, shared memory, stack and spills of each library built
# in this run ([build])
PTXAS = {}


def fill_launch(N, nb=1, k=None, name=None) -> dict:
    """How a fill step launches, from its library's C plan query, with the
    library's ptxas line: the water-fill body (csrc/water_fill.cuh) of K3
    (name None, k None: one shard of N nodes, nb branch slots), K2
    (`flat_fill`: one shard, one slot) or K20 (k shards of N / k); or K9's
    radix select (`binpack_fill`, csrc/binpack_select.cuh; over k shards
    `sharded_binpack_fill`, K21)."""
    from swarmkit_tpu_torch.ops import _kernels

    name = name or ("tree_fill" if k is None else "sharded_water_fill")
    buf = (ctypes.c_int * 4)(0, 0, 0, 0)
    cdll = _kernels.lib(name)
    if name == "tree_fill":
        rc = cdll.skt_tree_fill_plan(N, nb, buf)
    elif name == "sharded_water_fill":
        rc = cdll.skt_sharded_water_fill_plan(k, N // k, nb, buf)
    elif name == "sharded_binpack_fill":
        rc = cdll.skt_sharded_binpack_fill_plan(k, N // k, buf)
    else:
        rc = getattr(cdll, f"skt_{name}_plan")(N, buf)
    if rc:
        fail(f"{name}: plan query, CUDA error {rc}")
    C, smem, node_smem, shared = buf
    nodes = (f"nodes in {'shared memory' if node_smem else 'device scratch'}")
    route = nodes if "binpack" in name else (
        f"{'shared' if shared else 'global'} route, {nodes}")
    return dict(route=route, cluster=C, smem_bytes=smem,
                ptxas=PTXAS.get(name, "not rebuilt in this run"))


def _launch_text(plan) -> str:
    return (f"cluster of {plan['cluster']} blocks x 1024 threads, "
            f"{plan['smem_bytes']} B dynamic shared memory, {plan['route']};"
            f" ptxas: {plan['ptxas']}")


def binpack_keys(tables, state, groups) -> str:
    """K9's key route on these inputs, group by group as its steps see
    them (the plain steps fold a copy of `state`): a packed key of at most
    63 bits and its 8-bit passes, the four components above 63, or no
    search (q is 0 or the whole capacity, or the group is refused)."""
    from swarmkit_tpu_torch.ops import placement as pl

    st = _clone(state)
    out = torch.zeros(tables.mask.shape, dtype=torch.int32,
                      device=tables.mask.device)
    flags = torch.zeros(out.shape[0], dtype=torch.int32, device=out.device)
    N = out.shape[1]
    widths, skipped = [], 0
    for g in groups:
        cap, svc = pl._node_caps_plain(tables, st, g)
        capsum = int(cap.sum(dtype=torch.int64))
        q = min(int(tables.n_tasks[g]), capsum)
        if capsum >= 1 << 31 or q <= 0 or q >= capsum:
            skipped += 1
        else:
            has = cap > 0
            sv, tot = svc[has].long(), st.totals[has].long()
            widths.append(1 + int(sv.max() - sv.min()).bit_length()
                          + int(tot.max() - tot.min()).bit_length()
                          + (N - 1).bit_length())
        pl.binpack_fill_step_plain(tables, st, g, out, flags)
    packed = [w for w in widths if w <= 63]
    text = (f"packed keys of {min(packed)}-{max(packed)} bits "
            f"({-(-min(packed) // 8)}-{-(-max(packed) // 8)} passes) on "
            f"{len(packed)} groups" if packed else "no packed key")
    return (f"{text}, components on {len(widths) - len(packed)}, no search "
            f"on {skipped}")


def _tables_and_state(args, mask):
    from swarmkit_tpu_torch.ops.placement import FillState, FillTables

    (_, _, _, _, _, _, _, _, avail_res, total0, svc_count0, n_tasks,
     svc_idx, need_res, max_replicas, penalty, has_ports, group_ports,
     port_used0, spread_rank, _) = args
    tables = FillTables(mask, need_res, n_tasks, svc_idx, max_replicas,
                        penalty, has_ports, group_ports, spread_rank)

    def fresh_state():
        return FillState(total0.clone(), svc_count0.clone(),
                         avail_res.clone(), port_used0.clone())
    return tables, fresh_state


def _run_steps(step, tables, state, G, N):
    dev = state.totals.device
    out = torch.zeros((G, N), dtype=torch.int32, device=dev)
    flags = torch.ones(G, dtype=torch.int32, device=dev)   # steps write 0
    for g in range(G):
        step(tables, state, g, out, flags)
    return out, flags


# static_mask's arguments among the KERNEL_ARG_FIELDS
MASK_ARGS = (0, 1, 2, 3, 5, 6, 7, 4, 20)


def check_mask(name, p_args, dims):
    from swarmkit_tpu_torch.ops import placement as pl

    mask_args = [p_args[i] for i in MASK_ARGS]
    got = pl.static_mask(*mask_args)
    want = pl.static_mask_plain(*mask_args)
    err = int((got.int() - want.int()).abs().max())
    if err:
        fail(f"static_mask differs from its plain version on {name}")
    ms = time_ms(lambda: pl.static_mask(*mask_args), 200)
    g_ms = graph_ms(lambda: pl.static_mask(*mask_args))
    ns = host_ns(lambda: pl.static_mask(*mask_args))
    plain_ms = time_ms(lambda: pl.static_mask_plain(*mask_args), 20)
    G, N = dims["G"], dims["N"]
    b_ms, b_by = mask_bound(mask_args, 1, G, N)
    log(f"[kernels] static_mask on {name} ({G}x{N}): equal to plain; "
        f"{ms:.4f} ms, graph {g_ms:.5f} ms, host ns a call {ns:.0f} vs "
        f"plain {plain_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, graph_ms=g_ms, host_ns=ns), got


def mask_bound(mask_args, k, G, n) -> tuple[float, str]:
    """The bound of K1 over k shards of n nodes (k = 1: one device) on
    these rows. Bytes: each shard's node tables and extra mask read once,
    its mask written once, the group rows read once. Operations this
    run's rows need per node: a gather, compare and AND per real
    constraint; ~5 per valid platform row; 2 per required plugin; 3 per
    volume-topology segment; 3 a group for ready/extra/store."""
    _, node_val, _, node_plugins, cons, plat, plugs, _, vt = mask_args
    if isinstance(node_val, list):
        node_val, node_plugins = node_val[0], node_plugins[0]
    K, PL = node_val.shape[1], node_plugins.shape[1]
    C, P = cons.shape[1], plat.shape[1]
    VA, W = vt.shape[1], vt.shape[2]
    nbytes = (k * n * (1 + 4 * K + 8 + PL) + G * (12 * C + 8 * P + PL)
              + 4 * G * VA * W + 2 * k * G * n)
    row_ok = (vt[:, :, :1] >= 0) & (vt[:, :, :1] < 4)
    n_terms = (3 * int((cons[:, :, 0] >= 0).sum())
               + 5 * int((plat[:, :, 0] > -2).sum())
               + 2 * int(plugs.sum())
               + 3 * int((row_ok & (vt[:, :, 1::2] >= 0)).sum()))
    return bound(nbytes, k * n * n_terms + 3 * k * G * n)


def _shard_mask_args(args, b):
    return [a[b] if isinstance(a, list) else a for a in args]


def check_sharded_mask(where, args):
    """K1 over every shard in one launch (`sharded_static_mask`) against
    its plain version (static_mask_plain shard by shard) on `args`, the
    main path's recorded inputs (node-axis fields k shard tensors); ms a
    call by CUDA events, from a CUDA graph and by the host clock, beside
    the per-shard route (k one-device static_mask calls, the launch loops'
    route before the sharded entry). Returns the kernels-line row."""
    from swarmkit_tpu_torch.ops import placement as pl

    k = len(args[0])
    G, n = args[7][0].shape
    shards = [_shard_mask_args(args, b) for b in range(k)]
    got = pl.sharded_static_mask(*args)
    want = [pl.static_mask_plain(*a) for a in shards]
    err = max(int((a.int() - b.int()).abs().max()) if a.numel() else 0
              for a, b in zip(got, want))
    if err or len(got) != k:
        fail(f"sharded_static_mask differs from its plain version on {where}")

    def sharded():
        return pl.sharded_static_mask(*args)

    def per_shard():
        return [pl.static_mask(*a) for a in shards]

    row = {}
    for key, fn in (("sharded", sharded), ("per_shard", per_shard)):
        row[key] = dict(ms=time_ms(fn, 200), graph_ms=graph_ms(fn),
                        host_ns=host_ns(fn))
    plain_ms = time_ms(lambda: [pl.static_mask_plain(*a) for a in shards],
                       10)
    b_ms, b_by = mask_bound(args, k, G, n)
    s, p = row["sharded"], row["per_shard"]
    log(f"[kernels] sharded_static_mask on {where} ({k} shards x {G}x{n}): "
        f"equal to plain; one launch {s['ms']:.4f} ms, graph "
        f"{s['graph_ms']:.5f} ms, host ns a call {s['host_ns']:.0f}; the "
        f"per-shard route ({k} static_mask calls) {p['ms']:.4f} ms, graph "
        f"{p['graph_ms']:.5f} ms, host ns {p['host_ns']:.0f}; plain "
        f"{plain_ms:.4f} ms; library none; bound {b_ms:.6f} ms ({b_by})")
    return dict(max_abs_err=err, ms=s["ms"], plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                graph_ms=s["graph_ms"], host_ns=s["host_ns"],
                per_shard=p, shape=f"{k}x{G}x{n}")


def fill_bound(N, R, PV, lmax, ops_per_node=None) -> tuple[float, str]:
    """The bound of one group step over N nodes. Bytes: read the group's
    rows (mask, penalty, spread ids), read and write the node state
    (totals, service row, resources, ports), write the counts row.
    Operations: per node, the caps (2 per resource and port column, ~6
    more), 3 per spread level for the branch sums, and the leaf's 31-step
    bisect at 4 per step (the water fill) or `ops_per_node` more
    (binpack)."""
    nbytes = N * (2 + 4 * lmax + 2 * (4 + 4 + 4 * R + PV)) + 4 * N
    extra = 3 * lmax + 31 * 4 if ops_per_node is None else ops_per_node
    return bound(nbytes, N * (2 * R + 2 * PV + 6 + extra))


def check_fill(name, p_args, dims, mask, kernel_step, plain_step, lmax,
               ops_per_node=None, launch=None):
    """K2, K3 or K9 against its plain version over every group from fresh
    copies of the state; ms a step by CUDA events, the plain version's,
    the bound; with `launch` (the library) also from a CUDA graph, and how
    the step launches (K9: its key route on these inputs)."""
    tables, fresh_state = _tables_and_state(p_args, mask)
    G, N, R, PV = dims["G"], dims["N"], dims["R"], dims["PV"]
    s_k, s_p = fresh_state(), fresh_state()
    got, f_k = _run_steps(kernel_step, tables, s_k, G, N)
    want, f_p = _run_steps(plain_step, tables, s_p, G, N)
    if f_k.any() or f_p.any():
        fail(f"{kernel_step.__name__} on {name}: overflow flags set "
             f"(kernel {f_k.tolist()}, plain {f_p.tolist()})")
    err = max(int((a - b).abs().max()) for a, b in (
        (got, want), (s_k.totals, s_p.totals),
        (s_k.svc_counts, s_p.svc_counts), (s_k.avail, s_p.avail),
        (s_k.port_used.int(), s_p.port_used.int())))
    if err:
        fail(f"{kernel_step.__name__} differs from its plain version on "
             f"{name} (max abs err {err})")

    def per_launch(step, reps):
        total = 0.0
        for _ in range(reps):
            st = fresh_state()
            out = torch.zeros((G, N), dtype=torch.int32, device=mask.device)
            flags = torch.zeros(G, dtype=torch.int32, device=mask.device)
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for g in range(G):
                step(tables, st, g, out, flags)
            e1.record()
            e1.synchronize()
            total += e0.elapsed_time(e1)
        return total / (reps * G)

    per_launch(kernel_step, 1)                       # warm-up
    ms = per_launch(kernel_step, 5)
    plain_ms = per_launch(plain_step, 2)
    extra_row, extra_text = {}, ""
    if launch:  # the graph time and how the step launches
        g_ms = _graph_fill_ms(kernel_step, tables, fresh_state, G, N)
        plan = fill_launch(N, int(tables.spread_rank.max()) + 1
                           if lmax else 1, name=launch)
        extra_row = dict(graph_ms=g_ms, launch=plan)
        extra_text = f", graph {g_ms:.4f} ms; {_launch_text(plan)}"
        if launch == "binpack_fill":
            plan["keys"] = binpack_keys(tables, fresh_state(), range(G))
            extra_text += f"; {plan['keys']}"
    b_ms, b_by = fill_bound(N, R, PV, lmax, ops_per_node)
    log(f"[kernels] {kernel_step.__name__} on {name} (N={N}, LMAX={lmax}): "
        f"equal to plain over {G} steps; {ms:.4f} ms/launch vs plain "
        f"{plain_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by}){extra_text}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, **extra_row)


def _graph_fill_ms(step, tables, fresh_state, G, N):
    """Mean device ms per one-device group step from a CUDA graph of the G
    steps and the copies that restore the state before them."""
    pristine, state = fresh_state(), fresh_state()
    dev = tables.mask.device
    out = torch.zeros((G, N), dtype=torch.int32, device=dev)
    flags = torch.zeros(G, dtype=torch.int32, device=dev)

    def run():
        for a, b in zip(state, pristine):
            a.copy_(b)
        for g in range(G):
            step(tables, state, g, out, flags)

    return graph_ms(run, iters=1, reps=5) / G


def check_replay(acks, quorum):
    from swarmkit_tpu_torch.ops import raft_replay as rr

    c_k, m_k = rr.replay_commit(acks, quorum)
    c_p, m_p = rr.replay_commit_plain(acks, quorum)
    err = max(abs(int(c_k) - int(c_p)),
              int((m_k.int() - m_p.int()).abs().max()))
    if err:
        fail(f"replay_commit differs from its plain version (err {err})")
    ms = time_ms(lambda: rr.replay_commit(acks, quorum), 200)
    plain_ms = time_ms(lambda: rr.replay_commit_plain(acks, quorum), 50)
    M, E = acks.shape
    b_ms, b_by = bound(M * E + E + 8, 2 * M * E)
    log(f"[kernels] replay_commit ({M}x{E}): equal to plain; {ms:.4f} ms "
        f"vs plain {plain_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def phase_kernels(seed):
    from swarmkit_tpu_torch.convert import (
        check_kernel_args,
        kernel_args_from_arrays,
    )
    from swarmkit_tpu_torch.device import resolve_device
    from swarmkit_tpu_torch.models.cluster_step import example_cluster
    from swarmkit_tpu_torch.ops import placement as pl
    from swarmkit_tpu_torch.scheduler.encode import encode, kernel_args

    dev = resolve_device()          # the card
    t0 = time.perf_counter()
    grid_p = encode(grid_nodes(random.Random(seed), N_NODES), grid_groups(0))
    grid_b = encode(grid_nodes(random.Random(seed), N_NODES), grid_groups(0),
                    strategy="binpack")
    flag_p = encode(*example_cluster(N_NODES, N_GROUPS, TASKS_PER_GROUP,
                                     seed))
    log(f"[kernels] encoded the grid (spread, binpack) and flagship "
        f"problems in {time.perf_counter() - t0:.1f} s (host)")
    grid_a = kernel_args_from_arrays(kernel_args(grid_p), dev)
    bin_a = kernel_args_from_arrays(kernel_args(grid_b), dev)
    flag_a = kernel_args_from_arrays(kernel_args(flag_p), dev)
    gd, fd = check_kernel_args(grid_a), check_kernel_args(flag_a)
    if gd["L"] != 0 or fd["L"] == 0:
        fail(f"expected a flat grid and a tree flagship, got LMAX "
             f"{gd['L']} and {fd['L']}")
    results = {}
    results["static_mask"], flag_mask = check_mask("flagship", flag_a, fd)
    grid_mask = pl.static_mask(*[grid_a[i] for i in (0, 1, 2, 3, 5, 6, 7,
                                                     4, 20)])
    if not torch.equal(grid_mask, pl.static_mask_plain(
            *[grid_a[i] for i in (0, 1, 2, 3, 5, 6, 7, 4, 20)])):
        fail("static_mask differs from its plain version on the grid")
    results["flat_fill_step"] = check_fill(
        "grid", grid_a, gd, grid_mask, pl.flat_fill_step,
        pl.flat_fill_step_plain, 0, launch="flat_fill")
    results["tree_fill_step"] = check_fill(
        "flagship", flag_a, fd, flag_mask, pl.tree_fill_step,
        pl.tree_fill_step_plain, fd["L"], launch="tree_fill")
    # K9 on the binpack-encoded grid (the mask is the grid's: binpack only
    # changes the fill). Operations the function needs per node beyond the
    # caps: one lexicographic compare of its 4-key against the boundary's
    # (8), the prefix add (1), the clip (2); no sort is needed
    bin_mask = pl.static_mask(*[bin_a[i] for i in (0, 1, 2, 3, 5, 6, 7, 4,
                                                   20)])
    if not torch.equal(bin_mask, grid_mask):
        fail("the binpack-encoded grid's mask differs from the grid's")
    results["binpack_fill_step"] = check_fill(
        "grid binpack", bin_a, check_kernel_args(bin_a), bin_mask,
        pl.binpack_fill_step, pl.binpack_fill_step_plain, 0,
        ops_per_node=11, launch="binpack_fill")
    rng = np.random.RandomState(seed)
    acks = torch.from_numpy(rng.rand(N_MANAGERS, LOG_LEN) < 0.9999).to(dev)
    results["replay_commit"] = check_replay(
        acks, torch.tensor(N_MANAGERS // 2 + 1, dtype=torch.int32,
                           device=dev))
    return results, flag_p


def phase_waves(seed, strategy="spread"):
    """Three one-shot grid waves; the commit walk is the native one."""
    from swarmkit_tpu_torch.scheduler import batch
    from swarmkit_tpu_torch.scheduler.encode import IncrementalEncoder

    tag = "waves" if strategy == "spread" else strategy
    infos = grid_nodes(random.Random(seed), N_NODES)
    enc = IncrementalEncoder(strategy=strategy)
    for w in range(N_WAVES):
        groups = grid_groups(w)
        t0 = time.perf_counter()
        p = enc.encode(infos, groups)
        t1 = time.perf_counter()
        counts = batch.device_schedule_encoded(p)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        orders = batch.materialize_orders(p, counts)
        t3 = time.perf_counter()
        oracle = batch.cpu_schedule_encoded(p)
        t4 = time.perf_counter()
        if p.strategy != strategy or not np.array_equal(counts, oracle):
            bad = np.argwhere(counts != oracle)[0]
            fail(f"[{tag}] wave {w}: counts differ from the CPU oracle at "
                 f"(group, node) {tuple(bad)}")
        added = batch.apply_wave(p.row_infos, p.groups, orders)
        t5 = time.perf_counter()
        if added != int(oracle.sum()):
            fail(f"[{tag}] wave {w}: applied {added} tasks, oracle placed "
                 f"{int(oracle.sum())}")
        n_tasks = sum(len(g.tasks) for g in groups)
        log(f"[{tag}] wave {w}: {added}/{n_tasks} tasks placed on "
            f"{N_NODES} nodes, equal to the CPU oracle; wave "
            f"{(t3 - t0) + (t5 - t4):.3f} s = encode {t1 - t0:.3f} + device "
            f"{t2 - t1:.3f} + materialize {t3 - t2:.3f} + apply "
            f"{t5 - t4:.3f} (host clock); oracle {t4 - t3:.2f} s")


def phase_binpack_flagship(seed):
    """cluster_step(strategy=1) on the flagship cluster encoded for
    binpack, against the CPU oracle and a numpy tally."""
    from swarmkit_tpu_torch.convert import kernel_args_from_arrays
    from swarmkit_tpu_torch.device import resolve_device
    from swarmkit_tpu_torch.models.cluster_step import (
        cluster_step,
        example_cluster,
        example_inputs,
    )
    from swarmkit_tpu_torch.scheduler import batch
    from swarmkit_tpu_torch.scheduler.encode import encode, kernel_args

    dev = resolve_device()
    p = encode(*example_cluster(N_NODES, N_GROUPS, TASKS_PER_GROUP, seed),
               strategy="binpack")
    acks, quorum = example_inputs(n_nodes=1, n_groups=1, tasks_per_group=1,
                                  n_managers=N_MANAGERS, log_len=LOG_LEN,
                                  seed=seed)[:2]
    inputs = (acks, quorum) + kernel_args_from_arrays(kernel_args(p), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts, totals, commit = cluster_step(*inputs, strategy=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, totals = counts.cpu().numpy(), totals.cpu().numpy()
    oracle = batch.cpu_schedule_encoded(p)
    if p.strategy != "binpack" or not np.array_equal(counts, oracle):
        fail("binpack flagship counts differ from the CPU oracle")
    if not np.array_equal(totals, p.total0 + oracle.sum(axis=0)):
        fail("binpack flagship totals differ from the CPU oracle")
    a = acks.cpu().numpy()
    ok = a.sum(axis=0) >= int(quorum)
    want = a.shape[1] if ok.all() else int(np.argmin(ok))
    if int(commit) != want:
        fail(f"binpack flagship commit index {int(commit)} != numpy tally "
             f"{want}")
    log(f"[binpack] flagship step: {int(counts.sum())} of "
        f"{N_GROUPS * TASKS_PER_GROUP} tasks placed on {N_NODES} nodes "
        f"({int((counts.sum(axis=0) > 0).sum())} nodes used), equal to the "
        f"CPU oracle; commit index {int(commit)} equal to a numpy tally; "
        f"step {dt:.3f} s (host clock, synchronised)")


def info_state(info) -> tuple:
    """What the commit walk writes on a NodeInfo."""
    ar = info.available_resources
    return (info.mutations, info.active_tasks_count,
            dict(info.active_tasks_count_by_service), ar.nano_cpus,
            ar.memory_bytes, dict(ar.generic), sorted(info.used_host_ports),
            sorted(info.tasks))


def phase_native_walk(seed):
    """One grid wave booked by the C walk and by the pure-Python walk onto
    two copies of the same nodes: every NodeInfo equal, field for field."""
    from swarmkit_tpu_torch.scheduler import batch
    from swarmkit_tpu_torch.scheduler.encode import encode

    infos_c = grid_nodes(random.Random(seed + 5), N_NODES)
    infos_py = grid_nodes(random.Random(seed + 5), N_NODES)
    p = encode(infos_c, grid_groups(50))
    counts = batch.device_schedule_encoded(p)
    orders = batch.materialize_orders(p, counts)
    by_id = {i.node.id: i for i in infos_py}
    rows_py = [by_id[nid] for nid in p.node_ids]
    t0 = time.perf_counter()
    n_c = batch.apply_wave(p.row_infos, p.groups, orders, native_walk=True)
    t1 = time.perf_counter()
    n_py = batch.apply_wave(rows_py, p.groups, orders, native_walk=False)
    t2 = time.perf_counter()
    if not n_c == n_py == int(counts.sum()):
        fail(f"[native] walks added {n_c} and {n_py} of {int(counts.sum())}")
    for a, b in zip(infos_c, infos_py):
        if info_state(a) != info_state(b):
            fail(f"[native] node {a.node.id}: the C walk and the Python walk "
                 "disagree")
    log(f"[native] one grid wave ({n_c} tasks onto {N_NODES} nodes): every "
        f"NodeInfo equal between the walks; apply_wave {t1 - t0:.4f} s "
        f"native, {t2 - t1:.4f} s pure Python (host clock)")
    return t1 - t0, t2 - t1


def phase_flagship(seed, flag_p):
    from swarmkit_tpu_torch.entry import entry
    from swarmkit_tpu_torch.models.cluster_step import example_inputs
    from swarmkit_tpu_torch.scheduler import batch

    step, _ = entry()
    inputs = example_inputs(n_nodes=N_NODES, n_groups=N_GROUPS,
                            tasks_per_group=TASKS_PER_GROUP,
                            n_managers=N_MANAGERS, log_len=LOG_LEN,
                            seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts, totals, commit = step(*inputs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, totals = counts.cpu().numpy(), totals.cpu().numpy()
    oracle = batch.cpu_schedule_encoded(flag_p)
    if not np.array_equal(counts, oracle):
        fail("flagship counts differ from the CPU oracle")
    if not np.array_equal(totals, flag_p.total0 + oracle.sum(axis=0)):
        fail("flagship totals differ from the CPU oracle")
    acks = inputs[0].cpu().numpy()
    ok = acks.sum(axis=0) >= int(inputs[1])
    want = acks.shape[1] if ok.all() else int(np.argmin(ok))
    if int(commit) != want:
        fail(f"commit index {int(commit)} != numpy tally {want}")
    if counts.shape != (N_GROUPS, N_NODES) or not np.isfinite(counts).all():
        fail(f"flagship counts of shape {counts.shape}")
    log(f"[flagship] {int(counts.sum())} of {N_GROUPS * TASKS_PER_GROUP} "
        f"tasks placed on {N_NODES} nodes (LMAX "
        f"{flag_p.spread_rank.shape[1]}), equal to the CPU oracle; commit "
        f"index {int(commit)} of {LOG_LEN} equal to a numpy tally; step "
        f"{dt:.3f} s (host clock, synchronised)")


# ------------------------------------------------------------ steady tick
CARRY_FIELDS = ("ready", "node_val", "port_used", "avail_res", "total0",
                "svc_mat")


def tapped_resident(enc):
    """A ResidentPlacement that, right after each dispatch, copies the carry
    it left on the card into pinned host memory (non-blocking, then an
    event), so each wave's carry is checked once the wave completes without
    making the pipeline wait."""
    from collections import deque

    from swarmkit_tpu_torch.ops.resident import (
        STATE_FIELDS,
        ResidentPlacement,
    )

    class Tapped(ResidentPlacement):
        def __init__(self, encoder):
            super().__init__(encoder)
            self.taps = deque()

        def schedule_async(self, p):
            h = super().schedule_async(p)
            st = dict(zip(STATE_FIELDS, self._state))
            if st["total0"].is_cuda:
                host = {k: torch.empty(st[k].shape, dtype=st[k].dtype,
                                       pin_memory=True) for k in CARRY_FIELDS}
                for k in CARRY_FIELDS:
                    host[k].copy_(st[k], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record()
            else:
                host, ev = {k: st[k].clone() for k in CARRY_FIELDS}, None
            self.taps.append((host, ev))
            return h

    return Tapped(enc)


def check_wave(name, w, rp, p, counts):
    """The wave's counts against the CPU oracle on its completed problem,
    and the carry its dispatch left on the card against the kernels' fold
    (tests/test_resident.py expected_device_fold)."""
    from swarmkit_tpu_torch.scheduler import batch

    oracle = batch.cpu_schedule_encoded(p)
    if counts.shape != oracle.shape or not np.array_equal(counts, oracle):
        fail(f"[steady] {name} wave {w}: counts differ from the CPU oracle")
    host, ev = rp.taps.popleft()
    if ev is not None:
        ev.synchronize()
    st = {k: v.numpy() for k, v in host.items()}
    N, R, PV = len(p.node_ids), p.avail_res.shape[1], p.port_used0.shape[1]
    port = p.port_used0.copy()
    for gi in np.flatnonzero(counts.sum(axis=1)):
        port |= p.group_ports[gi][None, :] & (counts[gi] > 0)[:, None]
    want = {"total0": p.total0 + counts.sum(axis=0).astype(np.int32),
            "avail_res": (p.avail_res.astype(np.int64)
                          - counts.astype(np.int64).T
                          @ p.need_res.astype(np.int64)).astype(np.int32),
            "port_used": port, "ready": p.ready, "node_val": p.node_val}
    got = {"total0": st["total0"][:N], "avail_res": st["avail_res"][:N, :R],
           "port_used": st["port_used"][:N, :PV], "ready": st["ready"][:N],
           "node_val": st["node_val"][:N, :p.node_val.shape[1]]}
    # the service matrix: the tick's (tick-local) svc_count0 rows plus the
    # counts of their groups, in the resident rows svc_idx_persistent
    # names; no count in a padded node column
    svc = p.svc_count0.astype(np.int64)
    np.add.at(svc, p.svc_idx, counts)
    rows = dict(zip(p.svc_idx_persistent.tolist(), p.svc_idx.tolist()))
    want["svc_mat"] = svc[list(rows.values())].astype(np.int32)
    got["svc_mat"] = st["svc_mat"][list(rows), :N]
    if st["svc_mat"][:, N:].any():
        fail(f"[steady] {name} wave {w}: counts in padded svc_mat columns")
    for k in CARRY_FIELDS:
        if not np.array_equal(got[k], want[k]):
            fail(f"[steady] {name} wave {w}: carried {k} differs from the "
                 "expected fold")
    return int(counts.sum())


def finish_tasks(enc, infos, n_nodes):
    """Task completions on n_nodes nodes (one task each), fed to the
    tracked encoder as marks: external node changes, so the next tick
    drains and ships those rows as deltas."""
    done = 0
    for info in infos:
        if done == n_nodes:
            break
        if info.tasks:
            info.remove_task(next(iter(info.tasks.values())))
            enc.mark_numeric(info)
            done += 1
    return done


def steady_run(name, rec, infos, make_groups, n_waves, churn_at,
               invalidate_at, depth=3, async_commit=True, strategy="spread",
               record=True, mesh=None, against=None):
    """A cold tick (ResidentPlacement.schedule, full upload), then n_waves
    steady waves through TickPipeline(depth, async_commit), then a flush,
    on a tracked encoder (the zero-scan steady path the scheduler takes).
    Task completions before wave churn_at ship delta rows; invalidate()
    before wave invalidate_at forces a cold re-upload. Both drain the pipe,
    so they come after the steady stretch. Every completed wave is checked
    after the flush, outside the timed stretch (the carry taps wait in
    pinned memory). The recorder keeps the first steady wave's placement
    inputs under this configuration's name when `record`. With `mesh` the
    tick is MeshResidentPlacement on that mesh, and each wave's counts are
    held against `against` (the one-device run's) instead of the oracle
    and the carry taps. Returns the resident object and each wave's
    counts."""
    from swarmkit_tpu_torch.ops.pipeline import TickPipeline
    from swarmkit_tpu_torch.scheduler import batch
    from swarmkit_tpu_torch.scheduler.encode import IncrementalEncoder

    t0 = time.perf_counter()
    gc.disable()            # set-up: a million new objects, no garbage
    try:
        waves = [make_groups(w) for w in range(n_waves + 1)]
    finally:
        gc.enable()
    gc.collect()            # the collection the pause deferred, in set-up
    log(f"[steady] {name}: built {n_waves + 1} waves of pending tasks in "
        f"{time.perf_counter() - t0:.1f} s (host, not timed below)")
    by_node = {i.node.id: i for i in infos}

    def commit(p, counts):
        orders = batch.materialize_orders(p, counts)
        added = batch.apply_wave([by_node[nid] for nid in p.node_ids],
                                 p.groups, orders)
        if added != int(counts.sum()):
            raise RuntimeError(f"[steady] {name}: committed {added} of "
                               f"{int(counts.sum())} placements")

    enc = IncrementalEncoder(tracked=True, strategy=strategy)
    if mesh is None:
        rp = tapped_resident(enc)
    else:
        from swarmkit_tpu_torch.ops.resident_mesh import (
            MeshResidentPlacement,
        )

        rp = MeshResidentPlacement(enc, mesh)
    t0 = time.perf_counter()
    p = enc.encode(infos, waves[0])
    t1 = time.perf_counter()
    counts = rp.schedule(p)
    t2 = time.perf_counter()
    done = [(p, counts)]
    commit(p, counts)
    enc.apply_counts(p, counts)
    rp.after_apply(p, counts)
    t3 = time.perf_counter()
    log(f"[steady] {name} cold tick: encode {t1 - t0:.4f} + device "
        f"(upload, fill, pull) {t2 - t1:.4f} + commit {t3 - t2:.4f} s "
        f"(host clock)")

    pipe = TickPipeline(enc, rp, commit, depth=depth,
                        async_commit=async_commit)
    rec.config = name if record else None
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    try:
        for w in range(1, n_waves + 1):
            if w == churn_at:
                t0 = time.perf_counter()
                pipe.barrier()      # NodeInfos change between ticks
                t1 = time.perf_counter()
                n = finish_tasks(enc, infos, 32)
                log(f"[steady] {name}: {n} tasks finished before wave {w}, "
                    f"after a {t1 - t0:.4f} s commit barrier (host clock)")
            if w == invalidate_at:
                rp.invalidate()
                log(f"[steady] {name}: invalidate() before wave {w}")
            done.extend(pipe.tick(infos, waves[w]))
            t = pipe.timings[-1]
            log(f"[steady] {name} wave {w}: wall {t['wall_s']:.4f} s = "
                f"barrier {t['barrier_s']:.4f} + encode {t['encode_s']:.4f} "
                f"+ dirty scan {t['dirty_scan_s']:.4f} + dispatch "
                f"{t['dispatch_s']:.4f} + pull residual {t['pull_s']:.4f} + "
                f"fold {t['fold_s']:.4f} + commit {t['commit_s']:.4f}; "
                f"serial {t['serial_fallback']}, commit overlapped "
                f"{t['commit_overlapped']} (host clock)")
        rec.config = None
        n_ticks = len(pipe.timings)
        done.extend(pipe.flush())
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        pipe.close()
    for t in pipe.timings[n_ticks:]:
        log(f"[steady] {name} flush: wall {t['wall_s']:.4f} s = pull "
            f"residual {t['pull_s']:.4f} + fold {t['fold_s']:.4f} + commit "
            f"{t['commit_s']:.4f} (host clock)")
    w = pipe.worker
    if w is not None:
        log(f"[steady] {name} commit worker: {w.jobs_total} heavy halves, "
            f"busy {w.busy_s:.4f} s, per job "
            f"{[round(x, 4) for x in w.job_s]} (host clock); the wave loop "
            f"spent {sum(t['barrier_s'] for t in pipe.timings):.4f} s in "
            f"barriers")
    t0 = time.perf_counter()
    if against is None:
        placed = [check_wave(name, k, rp, p, c)
                  for k, (p, c) in enumerate(done)]
        checked = ("every wave equal to the CPU oracle and every carry "
                   "equal to the expected fold")
        if rp.taps:
            fail(f"[steady] {name}: {len(rp.taps)} carry taps unchecked")
    else:
        placed = [int(c.sum()) for _p, c in done]
        if len(done) != len(against) or any(
                not np.array_equal(c, w) for (_p, c), w in zip(done,
                                                               against)):
            fail(f"[steady] {name}: counts differ from the one-device "
                 "tick's on the same waves")
        checked = "every wave equal to the one-device tick's"
    t_check = time.perf_counter() - t0
    if len(placed) != n_waves + 1:
        fail(f"[steady] {name}: {len(placed)} waves completed of "
             f"{n_waves + 1}")
    log(f"[steady] {name}: {sum(placed)} tasks placed in {n_waves + 1} "
        f"waves {placed}, {checked} (checked in {t_check:.1f} s); "
        f"{t_end - t_start:.3f} s for the {n_waves} pipelined waves and the "
        f"flush (host clock, synchronised); uploads: full "
        f"{rp.uploads_full} {rp.uploads_svc}, delta rows "
        f"{rp.uploads_delta_rows}, group tables {rp.uploads_group_tables}, "
        f"{rp.uploads_h2d_bytes} bytes; pulls {rp.pulls}; "
        f"{sum(t['serial_fallback'] for t in pipe.timings)} serial ticks, "
        f"{sum(t['commit_overlapped'] for t in pipe.timings)} overlapped")
    return rp, [c for _p, c in done]


def flagship_waves(n_waves, seed):
    """The flagship cluster and n_waves waves of its 20 groups (new task
    ids and spec versions per wave)."""
    from swarmkit_tpu_torch.models.cluster_step import example_cluster

    infos, first = example_cluster(N_NODES, N_GROUPS, TASKS_PER_GROUP, seed)
    out = [first]
    for w in range(1, n_waves):
        _, groups = example_cluster(1, N_GROUPS, TASKS_PER_GROUP, seed)
        for g in groups:
            g.spec_version = w + 1
            for t in g.tasks:
                t.id = f"w{w}-{t.id}"
            g.ids = [t.id for t in g.tasks]
        out.append(groups)
    return infos, out


def flagship_ticks(seed, n_ticks, rec):
    """n_ticks serial resident ticks of the flagship cluster (tree fill,
    LMAX 3 padded to 4 levels, host ports, generic resources)."""
    from swarmkit_tpu_torch.scheduler import batch
    from swarmkit_tpu_torch.scheduler.encode import IncrementalEncoder

    infos, waves = flagship_waves(n_ticks, seed)
    by_node = {i.node.id: i for i in infos}
    enc = IncrementalEncoder(tracked=True)
    rp = tapped_resident(enc)
    for w, groups in enumerate(waves):
        rec.config = "flagship tree" if w else None
        t0 = time.perf_counter()
        p = enc.encode(infos, groups)
        t1 = time.perf_counter()
        counts = rp.schedule(p)
        t2 = time.perf_counter()
        if p.spread_rank.shape[1] != 3:
            fail(f"[steady] flagship tree: LMAX {p.spread_rank.shape[1]}")
        placed = check_wave("flagship tree", w, rp, p, counts)
        t3 = time.perf_counter()
        orders = batch.materialize_orders(p, counts)
        rows = [by_node[nid] for nid in p.node_ids]
        if batch.apply_wave(rows, p.groups, orders) != placed:
            fail("[steady] flagship tree: commit disagrees with counts")
        enc.apply_counts(p, counts)
        rp.after_apply(p, counts)
        t4 = time.perf_counter()
        log(f"[steady] flagship tree tick {w}: {placed} tasks placed, equal "
            f"to the CPU oracle, carry equal to the expected fold; encode "
            f"{t1 - t0:.4f} + device (upload, fill, pull) {t2 - t1:.4f} + "
            f"commit {t4 - t3:.4f} s (host clock)")
    rec.config = None
    return rp


def phase_steady(seed, recorder, ref):
    """The resident steady tick at full width: grid with the async and then
    the synchronous commit (dense pulls), the two runs equal wave for wave
    and NodeInfo for NodeInfo; grid under binpack (K9); node-heavy (sparse
    pulls); flagship tree. Only each run's upload and pull counters are
    kept, and in `ref` the async grid and node-heavy runs' counts,
    NodeInfos after the flush and final carry ([mesh_resident] holds the
    mesh tick against them)."""
    seen = {}

    def keep(name, rp):
        seen[name] = (dict(rp.uploads_svc), dict(rp.pulls))

    recorder.active = True
    first = None
    for k, mode in enumerate(("async", "sync")):
        name = "grid" + ("" if mode == "async" else " sync")
        infos = grid_nodes(random.Random(seed + 1), N_NODES)
        rp, counts = steady_run(
            name, recorder, infos,
            lambda w: grid_groups(100 + w, N_GROUPS, TASKS_PER_GROUP),
            STEADY_WAVES, churn_at=7, invalidate_at=8,
            async_commit=mode == "async", record=k == 0)
        keep(name, rp)
        run = (counts, [info_state(i) for i in infos])
        if first is None:
            ref["grid"] = (*run, rp.pull_state())
        del rp, infos
        if first is None:
            first = run
        elif len(run[0]) != len(first[0]) or any(
                not np.array_equal(a, b) for a, b in zip(run[0], first[0])):
            fail(f"[steady] {name}: placed differently from the async grid "
                 "run")
        elif run[1] != first[1]:
            fail(f"[steady] {name}: NodeInfos after the flush differ from "
                 "the async grid run's")
    log(f"[steady] grid: async and sync runs equal over "
        f"{len(first[0])} waves (counts) and {len(first[1])} NodeInfos "
        f"after the flush")
    del first, run
    for name, nodes, groups, strategy in (
            ("grid binpack", grid_nodes(random.Random(seed + 3), N_NODES),
             lambda w: grid_groups(300 + w, N_GROUPS, TASKS_PER_GROUP),
             "binpack"),
            ("node-heavy", grid_nodes(random.Random(seed + 2), HEAVY_NODES),
             lambda w: grid_groups(200 + w, N_GROUPS, HEAVY_PER_SERVICE),
             "spread")):
        rp, counts = steady_run(name, recorder, nodes, groups, STEADY_WAVES,
                                churn_at=7, invalidate_at=8,
                                strategy=strategy)
        keep(name, rp)
        if name == "node-heavy":
            ref[name] = (counts, [info_state(i) for i in nodes],
                         rp.pull_state())
        del rp, nodes
    keep("flagship tree", flagship_ticks(seed, FLAGSHIP_TICKS, recorder))
    recorder.active = False
    svc = {k: sum(v[0][k] for v in seen.values())
           for k in ("zeros", "sparse", "dense")}
    pulls = {k: sum(v[1][k] for v in seen.values())
             for k in ("dense", "sparse")}
    missing = [k for k, n in {**svc, **{f"pull {k}": n for k, n in
                                        pulls.items()}}.items() if n == 0]
    if missing:
        fail(f"[steady] branches not taken: {missing} (svc uploads {svc}, "
             f"pulls {pulls})")
    log(f"[steady] svc-matrix uploads {svc}; counts pulls {pulls}")


class Recorder:
    """Keeps the first main-path inputs of each recorded kernel under its
    key (cloned before the call, in stream order), so the kernel checks
    run at the shapes and on the data the steady phase gave them. A key
    of None records nothing."""

    def __init__(self):
        self.active = False
        self.config = None      # the steady configuration past its cold tick
        self.calls = {}

    def wrap(self, mod, name, key=None):
        setattr(mod, name, _Recording(self, getattr(mod, name),
                                      key or (lambda args: name)))


class _Recording:
    """Stands in for a kernel wrapper in its module while recording; the
    wrapper's own `launches` count (which it bumps through the module
    name) stays on the wrapper."""

    def __init__(self, rec, real, key):
        self.rec, self.real, self.key = rec, real, key

    @property
    def launches(self):
        return self.real.launches

    @launches.setter
    def launches(self, n):
        self.real.launches = n

    def __call__(self, *args):
        k = self.key(args)
        if self.rec.active and k is not None and k not in self.rec.calls:
            self.rec.calls[k] = _clone(args)
        return self.real(*args)


def _clone(a):
    """A copy of a's tensors, nested in lists, tuples and named tuples."""
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*map(_clone, a))
    if isinstance(a, (list, tuple)):
        return type(a)(map(_clone, a))
    return a


def _time_pair(kernel, plain, iters=50):
    return time_ms(kernel, iters), time_ms(plain, max(5, iters // 10))


def time_turns(kernel, library, iters=300, rounds=10):
    """A kernel's wrapper against the one PyTorch call that computes the
    same function, host-issued ms per call (`time_ms`), timed in turns
    (kernel, library, kernel, library, ...) in this process: (mean kernel
    ms, mean library ms, [[kernel ms, library ms] of each turn])."""
    turns = [[time_ms(kernel, iters), time_ms(library, iters)]
             for _ in range(rounds)]
    return (sum(k for k, _ in turns) / rounds,
            sum(lb for _, lb in turns) / rounds, turns)


def _turns_text(turns):
    return ", ".join(f"{k:.4f} / {lb:.4f}" for k, lb in turns)


def _ns_turns_text(turns):
    return ", ".join(f"{k:.0f} / {lb:.0f}" for k, lb in turns)


def host_ns(fn, calls=3000):
    """Host ns per call of fn: perf_counter over `calls` back-to-back calls
    after 200 warm-up ones, the card synchronised before and after."""
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter_ns() - t0) / calls


def host_turns(kernel, library, rounds=10):
    """`host_ns` of a kernel's wrapper against its library call, in turns
    as `time_turns`: (mean kernel ns, mean library ns, [[kernel ns,
    library ns] of each turn])."""
    turns = [[host_ns(kernel), host_ns(library)] for _ in range(rounds)]
    return (sum(k for k, _ in turns) / rounds,
            sum(lb for _, lb in turns) / rounds, turns)


def graph_ms(fn, iters=20, reps=10) -> float:
    """Mean device ms per call of fn: `iters` calls captured in one CUDA
    graph and replayed, so the host cost of a call (argument checks,
    ctypes) is paid once at capture and not per replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


# the fill each steady configuration runs
STEADY_FILLS = {"grid": "flat_fill_step", "node-heavy": "flat_fill_step",
                "flagship tree": "tree_fill_step",
                "grid binpack": "binpack_fill_step"}


def check_steady_placement(rec):
    """K1-K3 and K9 against their plain versions on the first steady wave's
    inputs of each configuration: the resident shapes (nodes padded to the
    bucket, LMAX 3 padded to 4 levels, group tables as row views). Each
    fill runs the wave's remaining groups from the recorded carry; counts
    and carry must be equal."""
    from swarmkit_tpu_torch.ops import placement as pl

    rows = {}
    for config, step in STEADY_FILLS.items():
        keys = (f"static_mask {config}", f"{step} {config}")
        missing = [k for k in keys if k not in rec.calls]
        if missing:
            fail(f"[steady] no steady-wave call recorded: {missing}")
        args = rec.calls[keys[0]]
        if not torch.equal(pl.static_mask.real(*args),
                           pl.static_mask_plain(*args)):
            fail(f"static_mask differs from its plain version on the "
                 f"{config} steady wave")
        tables, state, g0, out, flags = rec.calls[keys[1]]
        G, N = out.shape
        L = tables.spread_rank.shape[1]
        if config == "flagship tree" and L != 4:
            fail(f"[steady] flagship tree: {L} spread levels on the card, "
                 "expected LMAX 3 padded to 4")

        def run(fn):
            st, o, f = _clone(state), out.clone(), flags.clone()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for g in range(g0, G):
                fn(tables, st, g, o, f)
            e1.record()
            e1.synchronize()
            return (o, f, *st), e0.elapsed_time(e1) / (G - g0)

        got, _ = run(getattr(pl, step).real)
        want, plain_ms = run(getattr(pl, f"{step}_plain"))
        if got[1].any():
            fail(f"{step} on the {config} steady wave: overflow flags set")
        for a, b, what in zip(got, want,
                              ("counts", "flags") + state._fields):
            if not torch.equal(a, b):
                fail(f"{step} differs from its plain version on the "
                     f"{config} steady wave ({what})")
        ms = min(run(getattr(pl, step).real)[1] for _ in range(3))

        def steps(st=_clone(state), o=out.clone(), f=flags.clone(),
                  src=_clone(state), real=getattr(pl, step).real):
            for a, b in zip(st, src):
                a.copy_(b)
            for g in range(g0, G):
                real(tables, st, g, o, f)
        g_ms = graph_ms(steps, iters=1, reps=5) / (G - g0)
        name = step.removesuffix("_step")
        plan = fill_launch(N, int(tables.spread_rank.max()) + 1 if L else 1,
                           name=name)
        extra = f", graph {g_ms:.4f} ms; {_launch_text(plan)}"
        if name == "binpack_fill":
            plan["keys"] = binpack_keys(tables, state, range(g0, G))
            extra += f"; {plan['keys']}"
        b_ms, b_by = fill_bound(N, tables.need_res.shape[1],
                                tables.group_ports.shape[1], L,
                                11 if name == "binpack_fill" else None)
        row = "steady" if config in ("grid", "flagship tree",
                                     "grid binpack") else "node_heavy"
        rows[f"{step} {row}"] = dict(
            ms=ms, graph_ms=g_ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, launch=plan,
            shape=f"{config}: G={G} (groups {g0}-{G - 1}), N={N}, LMAX {L}")
        log(f"[kernels] static_mask and {step} on the {config} steady wave "
            f"(G={G}, N={N}, LMAX {L}, groups {g0}-{G - 1}): equal to "
            f"plain; {step} {ms:.4f} ms/launch vs plain {plain_ms:.4f} ms; "
            f"bound {b_ms:.5f} ms ({b_by}){extra}")
    return rows


def check_resident_kernels(rec):
    """K5-K8 against their plain versions on the recorded main-path inputs;
    times by CUDA events."""
    from swarmkit_tpu_torch.ops import resident as rs

    out = {}
    # K5: the churn tick's delta rows, on a copy of the state
    state, deltas = rec.calls["resident_delta_scatter"]
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]
    rs.resident_delta_scatter.real(got, deltas)
    rs.resident_delta_scatter_plain(want, deltas)
    err = max(int((a.int() - b.int()).abs().max()) if a.numel() else 0
              for a, b in zip(got, want))
    if err:
        fail(f"resident_delta_scatter differs from its plain version ({err})")
    ms, plain_ms = _time_pair(lambda: rs.resident_delta_scatter.real(
        got, deltas), lambda: rs.resident_delta_scatter_plain(want, deltas))
    D = deltas[0].shape[0]
    row = sum(d[:1].numel() * d.element_size() for d in deltas[1:8]) \
        + deltas[8].shape[0] * 4
    b_ms, b_by = bound(D * (4 + 2 * row), 0)
    N = state[0].shape[0]
    log(f"[kernels] resident_delta_scatter (D={D}, N={N}): equal to plain; "
        f"{ms:.4f} ms vs plain {plain_ms:.4f} ms; bound {b_ms:.6f} ms "
        f"({b_by})")
    out["resident_delta_scatter"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, shape=f"D={D}, N={N}")

    # K6: a grid tick's dense pull
    counts, g, n, compact = rec.calls["counts_window"]
    got = rs.counts_window.real(counts, g, n, compact)
    want = rs.counts_window_plain(counts, g, n, compact)
    err = int((got.int() - want.int()).abs().max())
    if err or got.dtype != want.dtype:
        fail("counts_window differs from its plain version")
    vector = rs.window_vector(counts.data_ptr(), got.data_ptr(), n,
                              counts.shape[1])
    ms, lib_ms, turns = time_turns(
        lambda: rs.counts_window.real(counts, g, n, compact),
        lambda: counts[:g, :n].to(
            torch.int16 if compact else torch.int32).contiguous())
    plain_ms = time_ms(lambda: rs.counts_window_plain(counts, g, n, compact),
                       20)
    ns, lib_ns, ns_turns = host_turns(
        lambda: rs.counts_window.real(counts, g, n, compact),
        lambda: counts[:g, :n].to(got.dtype).contiguous())
    b_ms, b_by = bound(g * n * (4 + (2 if compact else 4)), 0)
    log(f"[kernels] counts_window ({g}x{n} of {tuple(counts.shape)}, "
        f"{got.dtype}, {'vector' if vector else 'scalar'} path): equal to "
        f"plain; {ms:.4f} ms vs plain {plain_ms:.4f} ms, library "
        f"{lib_ms:.4f} ms (in turns, kernel / library: "
        f"{_turns_text(turns)}); host ns a call {ns:.0f} vs library "
        f"{lib_ns:.0f} (in turns: {_ns_turns_text(ns_turns)}); bound "
        f"{b_ms:.6f} ms ({b_by})")
    out["counts_window"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, turns_ms=turns, host_ns=ns,
        library_host_ns=lib_ns, host_ns_turns=ns_turns,
        shape=f"{g}x{n} of {tuple(counts.shape)}")

    # K7: a node-heavy tick's sparse pull
    counts, g, n, k, compact = rec.calls["sparse_counts"]
    got = rs.sparse_counts.real(counts, g, n, k, compact)
    want = rs.sparse_counts_plain(counts, g, n, k, compact)
    err = max(int((a.int() - b.int()).abs().max()) for a, b in zip(got, want))
    if err or got[1].dtype != want[1].dtype:
        fail("sparse_counts differs from its plain version")
    ms, plain_ms = _time_pair(
        lambda: rs.sparse_counts.real(counts, g, n, k, compact),
        lambda: rs.sparse_counts_plain(counts, g, n, k, compact), 200)
    b_ms, b_by = bound(g * n * 4 + k * (4 + (2 if compact else 4)), g * n)

    def library():
        flat = counts[:g, :n].reshape(-1)
        nz = torch.nonzero_static(flat, size=k, fill_value=0).reshape(-1)
        return nz, flat[nz]
    try:
        lib_idx, lib_val = library()
        same = (torch.equal(lib_idx.int(), got[0])
                and torch.equal(lib_val.int(), got[1].int()))
    except (RuntimeError, NotImplementedError) as e:
        same, lib_idx = False, e
    lib_ms = time_ms(library, 200) if same else None
    if not same:
        log(f"[kernels] torch.nonzero_static + gather does not compute "
            f"sparse_counts' function here ({lib_idx!r:.200}): no library "
            "time")
    log(f"[kernels] sparse_counts (k={k} of {g}x{n} in "
        f"{tuple(counts.shape)}): equal to plain; {ms:.4f} ms vs plain "
        f"{plain_ms:.4f} ms, library "
        f"{'none' if lib_ms is None else f'{lib_ms:.4f}'} ms; bound "
        f"{b_ms:.6f} ms ({b_by})")
    out["sparse_counts"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, shape=f"k={k} of {g}x{n}")

    # K8: the node-heavy cold re-upload's sparse scatter-add (and the
    # zeros), each in turns with its library call
    for key in ("svc_matrix_build zeros", "svc_matrix_build"):
        idx, vals, rows, cols = rec.calls[key]
        got = rs.svc_matrix_build.real(idx, vals, rows, cols)
        want = rs.svc_matrix_build_plain(idx, vals, rows, cols)
        err = int((got - want).abs().max())
        if err:
            fail(f"{key} differs from its plain version")
        nnz = idx.shape[0]
        idx64 = idx.long()

        def kernel(idx=idx, vals=vals, rows=rows, cols=cols):
            return rs.svc_matrix_build.real(idx, vals, rows, cols)

        if nnz:
            def library(idx64=idx64, vals=vals, rows=rows, cols=cols):
                return torch.zeros(rows * cols, dtype=torch.int32,
                                   device=idx64.device).scatter_add_(
                                       0, idx64, vals)
        else:
            def library(rows=rows, cols=cols, dev=idx.device):
                return torch.zeros(rows, cols, dtype=torch.int32,
                                   device=dev)
        if not torch.equal(library().view(rows, cols), got):
            fail(f"the library call does not compute {key}'s function")
        ms, lib_ms, turns = time_turns(kernel, library)
        plain_ms = time_ms(
            lambda: rs.svc_matrix_build_plain(idx, vals, rows, cols), 20)
        ns, lib_ns, ns_turns = host_turns(kernel, library)
        lib_g_ms = graph_ms(library)
        b_ms, b_by = bound(rows * cols * 4 + nnz * 8, nnz)
        lib_name = "zeros + scatter_add_" if nnz else "zeros"
        log(f"[kernels] {key} (nnz={nnz}, {rows}x{cols}): equal to plain; "
            f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, library ({lib_name}) "
            f"{lib_ms:.4f} ms (in turns, kernel / library: "
            f"{_turns_text(turns)}); host ns a call {ns:.0f} vs library "
            f"{lib_ns:.0f} (in turns: {_ns_turns_text(ns_turns)}); library "
            f"graph {lib_g_ms:.5f} ms; bound {b_ms:.6f} ms ({b_by})")
        out[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                        library_graph_ms=lib_g_ms, turns_ms=turns,
                        host_ns=ns, library_host_ns=lib_ns,
                        host_ns_turns=ns_turns,
                        shape=f"nnz={nnz}, {rows}x{cols}")

    # the device time alone, without each call's host cost
    state, deltas = rec.calls["resident_delta_scatter"]
    state = [t.clone() for t in state]
    calls = {
        "resident_delta_scatter": lambda: rs.resident_delta_scatter.real(
            state, deltas),
        "counts_window": lambda: rs.counts_window.real(
            *rec.calls["counts_window"]),
        "sparse_counts": lambda: rs.sparse_counts.real(
            *rec.calls["sparse_counts"]),
        "svc_matrix_build zeros": lambda: rs.svc_matrix_build.real(
            *rec.calls["svc_matrix_build zeros"]),
        "svc_matrix_build": lambda: rs.svc_matrix_build.real(
            *rec.calls["svc_matrix_build"])}
    for key, fn in calls.items():
        out[key]["graph_ms"] = graph_ms(fn)
        log(f"[kernels] {key}: {out[key]['graph_ms']:.5f} ms per call "
            f"replayed from a CUDA graph, against {out[key]['ms']:.4f} ms "
            f"per call issued from the host")
    out["svc_matrix_build"]["zeros"] = out.pop("svc_matrix_build zeros")
    return out


# ------------------------------------------------------------ raft replay
REPLAY_ENTRIES = 1_000_000     # bench.py's raft-replay row: 5 x 1,000,000
BURST, N_BURSTS = 16, 4        # 4 bursts of 16 frontier advances
SCAN_CHUNK = 65_536


def _np_commit(acks, quorum) -> int:
    ok = acks.sum(axis=0, dtype=np.int32) >= quorum
    return acks.shape[1] if ok.all() else int(np.argmin(ok))


def phase_replay(seed, rec):
    """The raft replay burst at bench.py's shape (bench.py:580-660): the
    cold bit-packed upload (K10), a replay (K4), 4 bursts of 16 frontier
    advances on the resident matrix (K11) and one single advance, the
    leader-side rule on every round's frontiers (K12), and the streaming
    scan (K13) on that matrix (E not a multiple of the chunk) and on the
    flagship's 5 x 2^20 log. Every commit against numpy. Keeps the inputs
    of each kernel in `rec` for the checks against the plain versions."""
    from swarmkit_tpu_torch.device import resolve_device
    from swarmkit_tpu_torch.ops import raft_replay as rr
    from swarmkit_tpu_torch.ops.bitpack import pack_bits

    dev = resolve_device()
    M, E = N_MANAGERS, REPLAY_ENTRIES
    rng = np.random.default_rng(1)          # bench.py:596-601
    acks = np.zeros((M, E), bool)
    frontier = rng.integers(E // 2, E, M).astype(np.int32)
    for m in range(M):
        acks[m, :frontier[m]] = True
    quorum = M // 2 + 1

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed = torch.from_numpy(pack_bits(acks)).to(dev)
    acks_dev = rr.unpack_acks(packed, E)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    rec["unpack_bits"] = (packed, E)
    if not np.array_equal(acks_dev.cpu().numpy(), acks):
        fail("[replay] the unpacked ack matrix differs from numpy's")
    commit, _ = rr.replay_commit(acks_dev, quorum)
    if int(commit) != _np_commit(acks, quorum):
        fail(f"[replay] replay_commit {int(commit)} != numpy tally")

    f = frontier
    bursts = []
    for _ in range(N_BURSTS):                # bench.py:624-632
        rounds = []
        for _ in range(BURST):
            f = np.minimum(f + rng.integers(0, 1000, M), E - 1) \
                .astype(np.int32)
            rounds.append(f)
        bursts.append(np.stack(rounds))
    rec["frontier_advance_burst"] = (acks_dev.clone(), bursts[0], quorum)
    rec["match_index_commit"] = (torch.from_numpy(bursts[0][0]).to(dev),
                                 quorum)
    a_dev, host = acks_dev, acks.copy()
    entry = np.arange(E, dtype=np.int32)[None, :]
    burst_s, n_rounds = 0.0, 0
    for fb in bursts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a_dev, commits = rr.frontier_advance_burst(a_dev, fb, quorum)
        commits = commits.cpu().numpy()
        burst_s += time.perf_counter() - t0
        for b, fr in enumerate(fb):
            host |= entry < fr[:, None]
            if commits[b] != _np_commit(host, quorum):
                fail(f"[replay] round {n_rounds}: commit {commits[b]} != "
                     f"numpy tally {_np_commit(host, quorum)}")
            mi = int(rr.match_index_commit(torch.from_numpy(fr).to(dev),
                                           quorum))
            if mi != int(np.sort(fr)[::-1][quorum - 1]):
                fail(f"[replay] round {n_rounds}: match_index_commit {mi} "
                     "!= numpy's quorum-th largest")
            n_rounds += 1
    if not np.array_equal(a_dev.cpu().numpy(), host):
        fail("[replay] the ack matrix after the bursts differs from numpy's")
    f_last = np.minimum(f + 1000, E - 1).astype(np.int32)
    a1, c1 = rr.frontier_advance(a_dev, f_last, quorum)
    host |= entry < f_last[:, None]
    if int(c1) != _np_commit(host, quorum) \
            or not np.array_equal(a1.cpu().numpy(), host):
        fail("[replay] frontier_advance differs from numpy")

    flag = torch.from_numpy(np.random.RandomState(seed).rand(
        N_MANAGERS, LOG_LEN) < 0.8).to(dev)   # example_inputs' log
    scans = {}
    for name, a in (("bench", a1), ("flagship", flag)):
        got = int(rr.replay_log_scan(a, quorum, SCAN_CHUNK))
        want = int(rr.replay_commit(a, quorum)[0])
        if got != want:
            fail(f"[replay] replay_log_scan on the {name} log: {got} != "
                 f"replay_commit's {want}")
        scans[name] = got
        rec[f"replay_log_scan {name}"] = (a, quorum, SCAN_CHUNK)
    log(f"[replay] {M}x{E} acks: cold packed upload + unpack "
        f"{cold_s:.4f} s; {n_rounds} rounds in {N_BURSTS} bursts "
        f"({burst_s:.4f} s host clock, each with its commits pulled), every "
        f"commit and the final matrix equal to numpy, every round's "
        f"match_index_commit equal to numpy's; commit {int(c1)} after one "
        f"more advance; replay_log_scan (chunk {SCAN_CHUNK}) "
        f"{scans['bench']} and {scans['flagship']} on the flagship's "
        f"{N_MANAGERS}x{LOG_LEN} log, equal to replay_commit")


def check_replay_kernels(rec):
    """K10-K13 against their plain versions on the replay phase's inputs;
    times by CUDA events; bounds from this run's shapes (and, for the scan,
    the columns this run's commit index makes it read)."""
    from swarmkit_tpu_torch.ops import bitpack as bp
    from swarmkit_tpu_torch.ops import raft_replay as rr

    out = {}

    def record(name, err, kernel, plain, nbytes, nops, lib=None,
               shape=""):
        if err:
            fail(f"{name} differs from its plain version ({shape}, err "
                 f"{err})")
        ms, plain_ms = _time_pair(kernel, plain)
        lib_ms = time_ms(lib, 200) if lib is not None else None
        b_ms, b_by = bound(nbytes, nops)
        log(f"[kernels] {name} ({shape}): equal to plain; {ms:.4f} ms vs "
            f"plain {plain_ms:.4f} ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f}'} ms; bound "
            f"{b_ms:.6f} ms ({b_by})")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         shape=shape)

    packed, E = rec["unpack_bits"]
    R, W = packed.shape
    got, want = bp.unpack_bits(packed, E), bp.unpack_bits_plain(packed, E)
    record("unpack_bits", int((got.int() - want.int()).abs().max()),
           lambda: bp.unpack_bits(packed, E),
           lambda: bp.unpack_bits_plain(packed, E),
           R * W + R * E, 2 * R * E, shape=f"{R}x{W} -> {R}x{E}")

    acks, fronts, q = rec["frontier_advance_burst"]
    B, M = fronts.shape
    E = acks.shape[1]
    fr_dev = torch.from_numpy(fronts).to(acks.device)
    ga, gc = rr.frontier_advance_burst(acks, fronts, q)
    wa, wc = rr.frontier_advance_burst_plain(acks, fr_dev, q)
    err = max(int((ga.int() - wa.int()).abs().max()),
              int((gc - wc).abs().max()))
    # per round and entry: M compares, ORs and adds, one quorum compare
    record("frontier_advance_burst", err,
           lambda: rr.frontier_advance_burst(acks, fronts, q),
           lambda: rr.frontier_advance_burst_plain(acks, fr_dev, q),
           2 * M * E + 4 * B * M + 4 * B, B * E * (3 * M + 1),
           shape=f"B={B}, {M}x{E}")

    mi, q = rec["match_index_commit"]
    M = mi.shape[0]
    q_dev = torch.tensor(q, dtype=torch.int32, device=mi.device)
    want = int(rr.match_index_commit_plain(mi, q))
    err = max(abs(int(rr.match_index_commit(mi, q)) - want),
              abs(int(rr.match_index_commit(mi, q_dev)) - want))
    if err:
        fail(f"match_index_commit differs from its plain version (M={M}, "
             f"quorum {q}, err {err})")
    if int(torch.kthvalue(mi, M - q + 1).values) != want:
        fail("torch.kthvalue does not compute match_index_commit's "
             "function")
    ms, lib_ms, turns = time_turns(
        lambda: rr.match_index_commit(mi, q),
        lambda: torch.kthvalue(mi, M - q + 1).values)
    ms_q_dev = time_ms(lambda: rr.match_index_commit(mi, q_dev), 500)
    plain_ms = time_ms(lambda: rr.match_index_commit_plain(mi, q), 20)
    ns, lib_ns, ns_turns = host_turns(
        lambda: rr.match_index_commit(mi, q),
        lambda: torch.kthvalue(mi, M - q + 1).values)
    g_ms = graph_ms(lambda: rr.match_index_commit(mi, q))
    g_ms_q_dev = graph_ms(lambda: rr.match_index_commit(mi, q_dev))
    b_ms, b_by = bound(4 * M + 8, 3 * M * M)
    log(f"[kernels] match_index_commit (M={M}, quorum {q}): equal to plain "
        f"(quorum an int and a CUDA tensor); {ms:.4f} ms vs plain "
        f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms (in turns, kernel / "
        f"library: {_turns_text(turns)}); host ns a call {ns:.0f} vs library "
        f"{lib_ns:.0f} (in turns: {_ns_turns_text(ns_turns)}); quorum a "
        f"CUDA tensor {ms_q_dev:.4f} ms; graph {g_ms:.5f} ms, quorum a "
        f"CUDA tensor {g_ms_q_dev:.5f} ms; bound {b_ms:.6f} ms ({b_by})")
    out["match_index_commit"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, graph_ms=g_ms, turns_ms=turns,
        ms_quorum_on_card=ms_q_dev, graph_ms_quorum_on_card=g_ms_q_dev,
        host_ns=ns, library_host_ns=lib_ns, host_ns_turns=ns_turns,
        shape=f"M={M}, quorum {q}")

    for key in ("replay_log_scan bench", "replay_log_scan flagship"):
        a, q, chunk = rec[key]
        M, E = a.shape
        got = int(rr.replay_log_scan(a, q, chunk))
        err = abs(got - int(rr.replay_log_scan_plain(a, q, chunk)))
        cols = min(E, (got // chunk + 1) * chunk)   # the scan stops there
        record(key, err, lambda: rr.replay_log_scan(a, q, chunk),
               lambda: rr.replay_log_scan_plain(a, q, chunk),
               M * cols + 4, M * cols + cols,
               shape=f"{M}x{E}, chunk {chunk}, commit {got}")
    # the kernels line carries the bench log's numbers; the flagship log's
    # are in the log above
    out["replay_log_scan"] = out.pop("replay_log_scan bench")
    del out["replay_log_scan flagship"]
    return out


# ------------------------------------------------------- the int32 guard
INT32_RESIDENT = (65_537, 16_384)   # nodes, tasks: padded to 131,072 nodes
INT32_ONE_SHOT = (20_000, 131_072)


def int32_group(n_tasks):
    """One service, no constraints or preferences, one CPU quantum a task."""
    from swarmkit_tpu_torch.api.objects import Task
    from swarmkit_tpu_torch.api.types import TaskState
    from swarmkit_tpu_torch.scheduler.encode import CPU_QUANTUM, TaskGroup

    tasks = []
    for ti in range(n_tasks):
        t = Task(id=f"big-{ti:06d}", service_id="svc-big", slot=ti + 1)
        t.desired_state = TaskState.RUNNING
        t.status.state = TaskState.PENDING
        tasks.append(t)
    tasks[0].spec.resources.reservations.nano_cpus = CPU_QUANTUM
    for t in tasks[1:]:
        t.spec = tasks[0].spec
    return TaskGroup(service_id="svc-big", spec_version=1, tasks=tasks,
                     ids=[t.id for t in tasks])


def phase_int32(seed):
    """Two ticks past the old N * max(n_tasks) >= 2^31 guard, whose
    capacity sums stay far below 2^31: a resident tick at 65,537 nodes
    (131,072 on the card) with a 16,384-task service, and the one-shot
    entry at 20,000 nodes with a 131,072-task service. Each places every
    task, equal to the CPU oracle."""
    from swarmkit_tpu_torch.ops.resident import ResidentPlacement
    from swarmkit_tpu_torch.scheduler import batch
    from swarmkit_tpu_torch.scheduler.encode import IncrementalEncoder, encode

    for name, (n_nodes, n_tasks) in (("resident", INT32_RESIDENT),
                                     ("one-shot", INT32_ONE_SHOT)):
        t0 = time.perf_counter()
        gc.disable()
        try:
            infos = grid_nodes(random.Random(seed), n_nodes)
            group = int32_group(n_tasks)
        finally:
            gc.enable()
        if name == "resident":
            enc = IncrementalEncoder()
            p = enc.encode(infos, [group])
            rp = ResidentPlacement(enc)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            counts = rp.schedule(p)
            padded = rp._state[0].shape[0]
        else:
            p = encode(infos, [group])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            counts = batch.device_schedule_encoded(p)
            padded = n_nodes
        dt = time.perf_counter() - t1
        if padded * n_tasks < 1 << 31:
            fail(f"[int32] {name}: {padded} x {n_tasks} does not reach the "
                 "old guard")
        if int(counts.sum()) != n_tasks:
            fail(f"[int32] {name}: placed {int(counts.sum())} of {n_tasks}")
        if not np.array_equal(counts, batch.cpu_schedule_encoded(p)):
            fail(f"[int32] {name}: counts differ from the CPU oracle")
        log(f"[int32] {name}: {n_tasks} tasks on {n_nodes} nodes ({padded} "
            f"on the card; N * n_tasks = {padded * n_tasks} >= 2^31) all "
            f"placed, equal to the CPU oracle; tick {dt:.4f} s (host clock), "
            f"set-up {t1 - t0:.1f} s")



# ------------------------------------------------- global-service reconcile
GLOBAL_NODES = 50_000         # bench.py:482, the global-diff row's nodes
GLOBAL_SERVICES = 20          # one zone each: 1/20 = 5% eligibility
GLOBAL_CHURN = 0.01           # of the nodes: drained, down, and added


def global_store(seed):
    """The startup reconcile's cluster: GLOBAL_NODES READY nodes labelled
    zone=z0..z19, GLOBAL_SERVICES global services each pinned to one zone,
    one RUNNING task per (service, node of its zone), then churn: 1% of the
    nodes drained, 1% down, 1% new READY nodes. Returns the store and the
    plain reference of its eligibility: per node (sorted by id) its zone
    row and whether it is READY+ACTIVE and whether it keeps tasks."""
    from swarmkit_tpu_torch.api.objects import Node, Service, Task
    from swarmkit_tpu_torch.api.specs import ServiceSpec
    from swarmkit_tpu_torch.api.types import (NodeAvailability,
                                              NodeStatusState, ServiceMode,
                                              TaskState)
    from swarmkit_tpu_torch.state.proposer import LocalProposer
    from swarmkit_tpu_torch.store.memory import MemoryStore

    S, N = GLOBAL_SERVICES, GLOBAL_NODES
    k = int(N * GLOBAL_CHURN)
    rng = np.random.default_rng(seed)
    store = MemoryStore(proposer=LocalProposer())

    def node(nid, zone):
        n = Node(id=nid)
        n.status.state = NodeStatusState.READY
        n.spec.availability = NodeAvailability.ACTIVE
        n.spec.annotations.labels = {"zone": f"z{zone}"}
        return n

    def converged(tx):
        for i in range(N):
            tx.create(node(f"node-{i:06d}", i % S))
        for s in range(S):
            svc = Service(id=f"global-{s:02d}",
                          spec=ServiceSpec(mode=ServiceMode.GLOBAL))
            svc.spec.annotations.name = f"global-{s:02d}"
            svc.spec.task.placement.constraints = [
                f"node.labels.zone == z{s}"]
            tx.create(svc)
        for i in range(N):
            t = Task(id=f"task-{i:06d}", service_id=f"global-{i % S:02d}",
                     node_id=f"node-{i:06d}")
            t.desired_state = TaskState.RUNNING
            t.status.state = TaskState.RUNNING
            tx.create(t)

    drained, down = np.split(rng.choice(N, 2 * k, replace=False), 2)

    def churn(tx):
        for i in drained:
            n = tx.get_node(f"node-{i:06d}").copy()
            n.spec.availability = NodeAvailability.DRAIN
            tx.update(n)
        for i in down:
            n = tx.get_node(f"node-{i:06d}").copy()
            n.status.state = NodeStatusState.DOWN
            tx.update(n)
        for i in range(N, N + k):
            tx.create(node(f"node-{i:06d}", int(rng.integers(S))))

    gc.disable()
    try:
        store.update(converged)
        store.update(churn)
    finally:
        gc.enable()
    nodes = sorted(store.view().find_nodes(), key=lambda n: n.id)
    zone = np.array([int(n.spec.annotations.labels["zone"][1:])
                     for n in nodes])
    ready = np.array([n.status.state == NodeStatusState.READY
                      and n.spec.availability == NodeAvailability.ACTIVE
                      for n in nodes])
    keeps = np.array([n.status.state != NodeStatusState.DOWN
                      and n.spec.availability != NodeAvailability.DRAIN
                      for n in nodes])
    return store, [n.id for n in nodes], zone, ready, keeps


def global_census(store, node_ids, S):
    """Per (service, node): the number of tasks with desired <= RUNNING,
    and of those the runnable ones."""
    from swarmkit_tpu_torch.api.types import TaskState

    col = {nid: i for i, nid in enumerate(node_ids)}
    active = np.zeros((S, len(node_ids)), np.int32)
    runnable = np.zeros_like(active)
    for t in store.view().find_tasks():
        if t.desired_state > TaskState.RUNNING or t.node_id not in col:
            continue
        s, n = int(t.service_id[-2:]), col[t.node_id]
        active[s, n] += 1
        runnable[s, n] += t.status.state <= TaskState.RUNNING
    return active, runnable


def phase_global(seed, rec):
    """A new leader's startup reconcile of the global services over the
    store, on the card: `view_and_watch(orch.setup)`, then `on_start`
    (check_tasks, then bulk_reconcile: the host scan, two K14 diffs through
    compute_diff at 20 x 50,500 = 1.01 M cells, the store batch). Every
    diff equal to numpy and to the plain version; afterwards every
    eligible (service, node) carries a runnable task and no node that
    keeps no tasks carries one, against a plain reference of eligibility;
    then one start()/stop() of the event loop, whose startup pass plans
    nothing. Keeps the first diff's inputs in `rec`."""
    from swarmkit_tpu_torch.device import resolve_device
    from swarmkit_tpu_torch.ops import reconcile as rc
    from swarmkit_tpu_torch.orchestrator import global_ as gmod
    from swarmkit_tpu_torch.orchestrator import taskinit
    from swarmkit_tpu_torch.utils.clock import Clock

    t0 = time.perf_counter()
    store, node_ids, zone, ready, keeps = global_store(seed)
    S, N = GLOBAL_SERVICES, len(node_ids)
    rows = np.arange(S)[:, None] == zone[None, :]
    want_elig, want_keeps = rows & ready[None, :], rows & keeps[None, :]
    setup_s = time.perf_counter() - t0
    log(f"[global] set-up {setup_s:.1f} s: {len(store.view().find_tasks())} "
        f"tasks on {N} nodes")
    if S * N < rc.DIFF_THRESHOLD:
        fail(f"[global] {S} x {N} cells is below DIFF_THRESHOLD")

    calls, spent = [], {"diff": 0.0, "apply": 0.0, "check": 0.0,
                        "restarts": 0}
    real_diff, real_check = rc.compute_diff, taskinit.check_tasks
    real_batch = store.batch

    def diff(eligible, task_nodes, device=None):
        t = time.perf_counter()
        out = real_diff(eligible, task_nodes, device=device)
        spent["diff"] += time.perf_counter() - t
        calls.append((eligible.copy(), task_nodes.copy(), out))
        return out

    def check(*a):
        t = time.perf_counter()
        try:
            fixed = real_check(*a)
            spent["restarts"] += fixed
            return fixed
        finally:
            spent["check"] += time.perf_counter() - t

    def batch(cb, *a, **kw):
        t = time.perf_counter()
        try:
            return real_batch(cb, *a, **kw)
        finally:
            spent["apply"] += time.perf_counter() - t

    class Observed(gmod.GlobalOrchestrator):
        """Says when its startup pass is over."""
        def on_start(self, snapshot):
            try:
                super().on_start(snapshot)
            finally:
                self.started.set()

    import threading

    rc.compute_diff, taskinit.check_tasks, store.batch = diff, check, batch
    orch = loop = None
    try:
        orch = gmod.GlobalOrchestrator(store)
        t1 = time.perf_counter()
        services, ch = store.view_and_watch(orch.setup, limit=None)
        try:
            orch.on_start(services)
        finally:
            store.queue.stop_watch(ch)
        start_s = time.perf_counter() - t1
        orch.stop()                       # cancels the restart timers
        if not spent["restarts"]:
            fail("[global] check_tasks restarted no task of the drained "
                 "and down nodes")
        wheel = Clock._wheel
        while wheel is not None and wheel._busy:
            time.sleep(0.01)              # a promote already under way
        if len(calls) != 2:
            fail(f"[global] bulk_reconcile made {len(calls)} diffs, not 2")
        if not np.array_equal(calls[0][0], want_elig) \
                or not np.array_equal(calls[1][0], want_keeps):
            fail("[global] the scan's eligibility differs from the plain "
                 "reference")
        dev = resolve_device()
        for eligible, task_nodes, (create, shutdown) in calls:
            want = rc.global_diff_np(eligible, task_nodes)
            plain = rc.global_diff_plain(torch.from_numpy(eligible).to(dev),
                                         torch.from_numpy(task_nodes).to(dev))
            for got, w, p in zip((create, shutdown), want, plain):
                if not (np.array_equal(got, w)
                        and np.array_equal(got, p.cpu().numpy())):
                    fail("[global] a K14 diff differs from numpy or the "
                         "plain version")
        rec["global_diff"] = calls[0][:2]
        active, runnable = global_census(store, node_ids, S)
        missing = int((want_elig & (runnable == 0)).sum())
        extra = int(((~want_keeps) & (active > 0)).sum())
        if missing or extra:
            fail(f"[global] after on_start: {missing} eligible pairs without "
                 f"a runnable task, {extra} pairs on nodes that keep no tasks "
                 "with one")
        creates = int(calls[0][2][0].sum())
        shutdowns = int(calls[1][2][1].sum())
        version = store.version.index

        loop = Observed(store)
        loop.started = threading.Event()
        t2 = time.perf_counter()
        loop.start()
        if not loop.started.wait(600):
            fail("[global] the event loop's startup pass did not finish")
        loop_s = time.perf_counter() - t2
        if store.version.index != version or len(calls) != 4:
            fail("[global] the second startup pass changed the store "
                 f"(version {version} -> {store.version.index}, "
                 f"{len(calls)} diffs)")
        loop.stop()
        if loop._thread.is_alive():
            fail("[global] the event loop's thread did not stop")
    finally:
        rc.compute_diff, taskinit.check_tasks = real_diff, real_check
        store.batch = real_batch
        for o in (orch, loop):
            if o is not None:
                o.stop()
        wheel = Clock._wheel
        if wheel is not None:             # the process-wide timer service
            wheel.stop()
            if wheel._thread is not None:
                wheel._thread.join(5)
            Clock._wheel = None
    bulk_s = start_s - spent["check"]
    log(f"[global] {S} services x {N} nodes ({rc.DIFF_THRESHOLD} cells at "
        f"least: {S * N}), {int(want_elig.sum())} eligible pairs; set-up "
        f"{setup_s:.1f} s; on_start {start_s:.4f} s = check_tasks "
        f"{spent['check']:.4f} ({spent['restarts']} restarts) + "
        f"bulk_reconcile "
        f"{bulk_s:.4f} (host clock)")
    log(f"[global] startup pass 1: host scan "
        f"{bulk_s - spent['diff'] - spent['apply']:.4f} s; both diffs "
        f"(upload, K14, pull) {spent['diff']:.4f} s; apply {spent['apply']:.4f} "
        f"s; {creates} creates, {shutdowns} shutdowns; every K14 diff equal "
        f"to numpy and the plain version, every eligible pair runnable, no "
        f"task left on a drained or down node")
    log(f"[global] start()/stop(): the loop's startup pass {loop_s:.4f} s "
        f"planned nothing (store at version {version}); thread joined")


# ------------------------------------------------ the O(churn) resident diff
RECONCILE_SHAPE = (200, 50_000, 2_000)  # bench.py:482, S, N, T
RECONCILE_BURST = 16
RECONCILE_REPS = 6


def _reconcile_updates(rng, S, T, U, B, N):
    """bench.py's mk_upd, B times: unique (service, slot) a round."""
    upds = []
    for _ in range(B):
        flat = rng.choice(S * T, U, replace=False)
        upds.append(((flat // T).astype(np.int32),
                     (flat % T).astype(np.int32),
                     rng.integers(-1, N, U).astype(np.int32)))
    return [np.stack([u[i] for u in upds]) for i in range(3)]


def phase_reconcile(seed, rec):
    """The device-resident O(churn) diff at bench_global_diff's shape
    (bench.py:463-578): the cold packed eligibility upload (K10) and the
    count carry (K16), 6 bursts of 16 churn rounds (K17) from the same
    converged carry, then round 16 again through global_diff_update (K14)
    and global_diff_update_compact (K14 + K15) on the state after round
    15. Every round's codes against the numpy full diff at its touched
    pairs; the carries and decisions against numpy."""
    from swarmkit_tpu_torch.device import resolve_device
    from swarmkit_tpu_torch.ops import reconcile as rc

    dev = resolve_device()
    S, N, T = RECONCILE_SHAPE
    rng = np.random.default_rng(0)           # bench.py:480-489
    eligible = rng.random((S, N)) < 0.04
    task_nodes = np.full((S, T), -1, np.int32)
    for si in range(S):
        elig_nodes = np.flatnonzero(eligible[si])
        k = min(T, elig_nodes.size)
        task_nodes[si, :k] = elig_nodes[:k]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed = torch.from_numpy(rc.pack_eligibility(eligible)).to(dev)
    tn_dev = torch.from_numpy(task_nodes).to(dev)
    elig_dev = rc.unpack_eligibility(packed, N)
    cnt_dev = rc.task_count_flat(tn_dev, N)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    rec["task_count_flat"] = (tn_dev, N)
    if not np.array_equal(elig_dev.cpu().numpy(), eligible):
        fail("[reconcile] the unpacked eligibility differs from numpy's")
    want_cnt = np.zeros(S * N, np.int32)
    valid = task_nodes >= 0
    np.add.at(want_cnt, (np.arange(S)[:, None] * N + task_nodes)[valid], 1)
    if not np.array_equal(cnt_dev.cpu().numpy(), want_cnt):
        fail("[reconcile] task_count_flat differs from numpy's count")

    U, B = S * T // 100, RECONCILE_BURST
    rows_b, cols_b, vals_b = _reconcile_updates(rng, S, T, U, B, N)
    rec["global_diff_churn_burst"] = (elig_dev, tn_dev, cnt_dev, rows_b,
                                      cols_b, vals_b)
    best, codes = None, None
    for _ in range(RECONCILE_REPS):      # each from the converged carry
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tn_b, cnt_b, codes_dev = rc.global_diff_churn_burst(
            elig_dev, tn_dev, cnt_dev, rows_b, cols_b, vals_b)
        codes = codes_dev.cpu().numpy()
        dt = time.perf_counter() - t0
        best = dt if best is None or dt < best else best

    tn_np = task_nodes.copy()
    for b in range(B):                       # bench.py:553-575, every round
        r, c, v = rows_b[b], cols_b[b], vals_b[b]
        old = tn_np[r, c]
        tn_np[r, c] = v
        create, shutdown = rc.global_diff_np(eligible, tn_np)
        svc = np.concatenate([r, r])
        node = np.concatenate([np.maximum(old, 0), np.maximum(v, 0)])
        ok = np.concatenate([old >= 0, v >= 0])
        want = (create[svc, node].astype(np.uint8)
                | (shutdown[svc, node].astype(np.uint8) << 1)) * ok \
            | (ok.astype(np.uint8) << 2)
        if not np.array_equal(codes[b], want):
            fail(f"[reconcile] round {b}: the burst's codes differ from the "
                 "numpy full diff at the touched pairs")
        if b == B - 2:
            tn_15 = tn_np.copy()
    if not np.array_equal(tn_b.cpu().numpy(), tn_np):
        fail("[reconcile] the burst's task table differs from numpy's")
    if not torch.equal(cnt_b, rc.task_count_flat(tn_b, N)):
        fail("[reconcile] the burst's count carry differs from K16 on its "
             "task table")

    t15_dev = torch.from_numpy(tn_15).to(dev)
    upd = (rows_b[-1], cols_b[-1], vals_b[-1])
    rec["global_diff_update"] = (elig_dev, t15_dev, *upd)
    tn_u, create_u, shutdown_u = rc.global_diff_update(elig_dev, t15_dev,
                                                       *upd)
    if not torch.equal(tn_u, tn_b):
        fail("[reconcile] global_diff_update's table differs from the "
             "burst's")
    if not (np.array_equal(create_u.cpu().numpy(), create)
            and np.array_equal(shutdown_u.cpu().numpy(), shutdown)):
        fail("[reconcile] global_diff_update's diff differs from numpy's")
    cap = 2 * U
    _, c_idx, s_idx, n_c, n_s = rc.global_diff_update_compact(
        elig_dev, t15_dev, *upd, cap)
    rec["diff_compact"] = (create_u, cap)
    for name, idx, n, m in (("create", c_idx, n_c, create),
                            ("shutdown", s_idx, n_s, shutdown)):
        hits = np.stack(np.nonzero(m), 1).astype(np.int32)
        want = np.full((cap, 2), -1, np.int32)
        want[:min(cap, len(hits))] = hits[:cap]
        if int(n) != len(hits) or not np.array_equal(idx.cpu().numpy(),
                                                     want):
            fail(f"[reconcile] the compact {name} list differs from numpy's "
                 "nonzero cut to cap")
    log(f"[reconcile] {S} x {N} cells, T {T}, U {U} (1%), burst {B}: cold "
        f"packed upload + unpack + count {cold_s:.4f} s; best of "
        f"{RECONCILE_REPS} bursts {best:.5f} s = {best / B:.6f} s a round "
        f"(host clock, codes pulled); every round's codes equal to the "
        f"numpy full diff at its {2 * U} touched pairs, carries equal; "
        f"update form equal; compact lists (cap {cap}) equal to numpy with "
        f"{int(n_c)} creates and {int(n_s)} shutdowns")


def check_reconcile_kernels(rec):
    """K14-K17 against their plain versions on the [global] and [reconcile]
    phases' inputs; times by CUDA events; bounds from this run's shapes."""
    from swarmkit_tpu_torch.device import resolve_device
    from swarmkit_tpu_torch.ops import reconcile as rc

    out = {}
    dev = resolve_device()

    def record(name, err, kernel, plain, nbytes, nops, lib=None, shape="",
               iters=50):
        if err:
            fail(f"{name} differs from its plain version ({shape}, err "
                 f"{err})")
        ms, plain_ms = _time_pair(kernel, plain, iters)
        lib_ms = time_ms(lib, iters) if lib is not None else None
        b_ms, b_by = bound(nbytes, nops)
        log(f"[kernels] {name} ({shape}): equal to plain; {ms:.4f} ms vs "
            f"plain {plain_ms:.4f} ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f}'} ms; bound "
            f"{b_ms:.6f} ms ({b_by})")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         shape=shape)

    def diff_err(a, b):
        return max(int((x.int() - y.int()).abs().max()) if x.numel() else 0
                   for x, y in zip(a, b))

    # K14 at the [global] path's shape, then its update form at [reconcile]'s
    elig, tn = (torch.from_numpy(a).to(dev) for a in rec["global_diff"])
    S, N = elig.shape
    T = tn.shape[1]
    record("global_diff", diff_err(rc.global_diff(elig, tn),
                                   rc.global_diff_plain(elig, tn)),
           lambda: rc.global_diff(elig, tn),
           lambda: rc.global_diff_plain(elig, tn),
           3 * S * N + 4 * S * T, S * T + 3 * S * N,
           shape=f"{S}x{N}, T={T}")
    e, t, r, c, v = rec["global_diff_update"]
    got = rc.global_diff_update(e, t, r, c, v)
    want = rc.global_diff_update(e.cpu(), t.cpu(), r, c, v)
    err = diff_err([g.cpu() for g in got], want)
    if err:
        fail("global_diff_update differs from its plain version")
    rd = [torch.from_numpy(x).to(dev) for x in (r, c, v)]

    def update_kernel():
        t1 = t.clone()
        return rc._diff_kernel(e, t1, rd)

    def update_plain():
        t1 = rc._set_slots_plain(t, *rd)
        return rc.global_diff_plain(e, t1)
    ms, plain_ms = _time_pair(update_kernel, update_plain)
    S2, N2 = e.shape
    T2, U = t.shape[1], r.shape[0]
    b_ms, b_by = bound(3 * S2 * N2 + 8 * S2 * T2 + 12 * U,
                       U + S2 * T2 + 3 * S2 * N2)
    log(f"[kernels] global_diff update form ({S2}x{N2}, T={T2}, U={U}; the "
        f"table copy and the device triples in): equal to plain; {ms:.4f} "
        f"ms vs plain {plain_ms:.4f} ms; bound {b_ms:.6f} ms ({b_by})")

    # K15 on the update's create matrix, cap 2U
    mask, cap = rec["diff_compact"]
    S, N = mask.shape
    gi, gn = rc.diff_compact(mask, cap)
    wi, wn = rc.diff_compact_plain(mask, cap)
    nz = torch.nonzero(mask)
    k = min(cap, nz.shape[0])
    if not torch.equal(nz[:k].int(), gi[:k]) or int(nz.shape[0]) != int(gn):
        fail("torch.nonzero does not give diff_compact's lists")
    record("diff_compact", diff_err([gi, gn[None]], [wi, wn[None]]),
           lambda: rc.diff_compact(mask, cap),
           lambda: rc.diff_compact_plain(mask, cap),
           S * N + 8 * cap + 4, S * N,
           lib=lambda: torch.nonzero(mask),
           shape=f"{S}x{N}, cap {cap}, count {int(gn)}")

    # K16 at the bench shape; the library is bincount on the masked index
    tn, N = rec["task_count_flat"]
    S, T = tn.shape
    flat = (torch.arange(S, device=dev)[:, None] * N
            + tn.clamp(0, N - 1))[tn >= 0]
    got = rc.task_count_flat(tn, N)
    if not torch.equal(torch.bincount(flat, minlength=S * N).int(), got):
        fail("torch.bincount does not compute task_count_flat's function")
    record("task_count_flat",
           int((got - rc.task_count_flat_plain(tn, N)).abs().max()),
           lambda: rc.task_count_flat(tn, N),
           lambda: rc.task_count_flat_plain(tn, N),
           4 * S * T + 4 * S * N, S * T,
           lib=lambda: torch.bincount(flat, minlength=S * N),
           shape=f"{S}x{T} into {S}x{N}")

    # K17: the burst from the converged carry, triples on the card
    e, tn, cnt, rows_b, cols_b, vals_b = rec["global_diff_churn_burst"]
    S, N = e.shape
    T = tn.shape[1]
    B, U = rows_b.shape
    trip = [torch.from_numpy(x).to(dev) for x in (rows_b, cols_b, vals_b)]
    got = rc._churn_kernel(e, tn, cnt, *trip)
    want = rc.global_diff_churn_burst_plain(e, tn, cnt, *trip)
    # the function returns new carries: read and written once each
    record("global_diff_churn_burst", diff_err(got, want),
           lambda: rc._churn_kernel(e, tn, cnt, *trip),
           lambda: rc.global_diff_churn_burst_plain(e, tn, cnt, *trip),
           2 * 4 * S * (T + N) + 2 * B * U + 12 * B * U + 2 * B * U,
           12 * B * U, shape=f"B={B}, U={U}, {S}x{N}, T={T}", iters=20)
    full = time_ms(lambda: rc.global_diff_churn_burst(e, tn, cnt, rows_b,
                                                      cols_b, vals_b), 20)
    on_card = time_ms(lambda: rc.global_diff_churn_burst(e, tn, cnt, *trip),
                      20)
    log(f"[kernels] global_diff_churn_burst through its wrapper: "
        f"{full:.4f} ms a burst from host triples (checked in numpy, one "
        f"upload), {on_card:.4f} ms from triples on the card (checked "
        f"there), against {out['global_diff_churn_burst']['ms']:.4f} ms "
        f"for the kernel with its carries' copies")

    # the device time alone, without each call's host cost
    elig, tn14 = (torch.from_numpy(a).to(dev) for a in rec["global_diff"])
    tn16, n16 = rec["task_count_flat"]
    calls = {
        "global_diff": lambda: rc.global_diff(elig, tn14),
        "diff_compact": lambda: rc.diff_compact(mask, cap),
        "task_count_flat": lambda: rc.task_count_flat(tn16, n16),
        "global_diff_churn_burst": lambda: rc._churn_kernel(e, tn, cnt,
                                                            *trip)}
    for key, fn in calls.items():
        out[key]["graph_ms"] = graph_ms(fn)
        log(f"[kernels] {key}: {out[key]['graph_ms']:.5f} ms per call "
            f"replayed from a CUDA graph, against {out[key]['ms']:.4f} ms "
            f"per call issued from the host")
    return out


# ------------------------------------------------------ the allocator plane
ALLOC_NODES = 50_000          # [global]'s node count
ALLOC_SUBNET = "10.0.0.0/16"  # docker network create --subnet 10.0.0.0/16
ALLOC_CHURN = 0.01            # of the nodes: drained, and added, in round 2
ALLOC_RECORD = (0, 125, 249)  # the startup chunks whose K19 inputs are kept


def alloc_master(seed):
    """The store a new leader's allocator finds: ALLOC_NODES READY nodes,
    one overlay network with `spec.ipam = {"subnet": ALLOC_SUBNET}`, one
    global service whose task template attaches to it, and the NEW tasks
    the global orchestrator's startup pass created for it. Returns the
    store's snapshot, round 2's writes (made once, so every run gets the
    same objects) and the set-up seconds."""
    from swarmkit_tpu_torch.api.objects import Network, Node, Service
    from swarmkit_tpu_torch.api.specs import (Annotations,
                                              NetworkAttachmentConfig,
                                              NetworkSpec, ServiceSpec)
    from swarmkit_tpu_torch.api.types import (NodeAvailability,
                                              NodeStatusState, ServiceMode)
    from swarmkit_tpu_torch.orchestrator import global_ as gmod
    from swarmkit_tpu_torch.orchestrator.task import new_task
    from swarmkit_tpu_torch.state.proposer import LocalProposer
    from swarmkit_tpu_torch.store import by
    from swarmkit_tpu_torch.store.memory import MemoryStore

    N = ALLOC_NODES
    k = int(N * ALLOC_CHURN)
    rng = np.random.default_rng(seed)
    store = MemoryStore(proposer=LocalProposer())

    def node(i):
        n = Node(id=f"node-{i:06d}")
        n.status.state = NodeStatusState.READY
        n.spec.availability = NodeAvailability.ACTIVE
        return n

    def build(tx):
        for i in range(N):
            tx.create(node(i))
        tx.create(Network(id="net-overlay", spec=NetworkSpec(
            annotations=Annotations(name="overlay"),
            ipam={"subnet": ALLOC_SUBNET})))
        svc = Service(id="svc-agent", spec=ServiceSpec(
            annotations=Annotations(name="agent"), mode=ServiceMode.GLOBAL))
        svc.spec.task.networks = [NetworkAttachmentConfig(
            target="net-overlay")]
        tx.create(svc)

    t0 = time.perf_counter()
    gc.disable()
    try:
        store.update(build)
        build_s = time.perf_counter() - t0
        orch = gmod.GlobalOrchestrator(store)
        try:
            t1 = time.perf_counter()
            services, ch = store.view_and_watch(orch.setup, limit=None)
            try:
                orch.on_start(services)
            finally:
                store.queue.stop_watch(ch)
            orch_s = time.perf_counter() - t1
        finally:
            orch.stop()
        view = store.view()
        tasks = view.find_tasks()
        if len(tasks) != N or any(t.networks for t in tasks):
            fail(f"[alloc] the orchestrator created {len(tasks)} tasks, not "
                 f"{N} NEW ones")
        # round 2, as the global orchestrator's node handlers decide it:
        # the drained nodes' tasks shut down (never assigned, so terminal
        # at once, mark_shutdown), a NEW task on every new node
        drained = [f"node-{i:06d}" for i in
                   sorted(rng.choice(N, k, replace=False))]
        gone = [t.id for nid in drained
                for t in view.find_tasks(by.ByNodeID(nid))]
        added = [node(i) for i in range(N, N + k)]
        svc = view.get_service("svc-agent")
        born = [new_task(None, svc, 0, node_id=n.id) for n in added]
        t2 = time.perf_counter()
        snap = store.save()
        save_s = time.perf_counter() - t2
    finally:
        gc.enable()
    return snap, (drained, gone, added, born), build_s, orch_s, save_s


def alloc_run(snap, round2, mode, rec=None):
    """One allocator over a store restored from `snap`: `mode` "card"
    (Allocator(store)), "plain" (device="cpu") or "scalar" (the scalar
    IPAM and PortAllocator swapped in: no allocate_many, the per-task
    loop). Round 1 is the event loop's startup pass (view_and_watch(setup),
    on_start); round 2 is one store transaction on the live loop: 1% of
    the nodes drained with their tasks shut down, then 1% new nodes with
    a NEW task each; the first release retries the NEW tasks in batches.
    The loop is stopped in a finally. Returns every task's (state,
    addresses), the pool's cursor and allocated set, and the timings."""
    import threading

    from swarmkit_tpu_torch.allocator import allocator as amod
    from swarmkit_tpu_torch.allocator.ipam import IPAM
    from swarmkit_tpu_torch.api.objects import EventCommit
    from swarmkit_tpu_torch.api.types import NodeAvailability
    from swarmkit_tpu_torch.ops import alloc as ga
    from swarmkit_tpu_torch.orchestrator.task import mark_shutdown
    from swarmkit_tpu_torch.state.proposer import LocalProposer
    from swarmkit_tpu_torch.store.memory import MemoryStore

    class Observed(amod.Allocator):
        """Says when its startup pass is over, which commit it has seen
        last, and when it went idle after it; keeps its errors."""

        def on_start(self, snapshot):
            try:
                super().on_start(snapshot)
            except Exception as e:
                self.errors.append(e)
                raise
            finally:
                self.started.set()

        def handle(self, ev):
            try:
                super().handle(ev)
            except Exception as e:
                self.errors.append(e)
                raise
            if isinstance(ev, EventCommit):
                self.seen = ev.version.index

        def idle(self):
            self.idle_at = self.seen
            self.went_idle.set()

    def wait_idle(what):
        """Until the loop has handled every commit and found no event for
        one poll interval."""
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            target = store.version.index
            alloc.went_idle.clear()
            if not alloc.went_idle.wait(60):
                continue
            if alloc.errors:
                fail(f"[alloc] {mode}: {what}: {alloc.errors[0]!r}")
            if alloc.idle_at >= target and store.version.index == target:
                return
        fail(f"[alloc] {mode}: the loop did not go idle after {what}")

    drained, gone, added, born = round2
    t0 = time.perf_counter()
    store = MemoryStore(proposer=LocalProposer())
    store.restore(snap)
    restore_s = time.perf_counter() - t0
    alloc = Observed(store, device="cpu" if mode == "plain" else None)
    if mode == "scalar":
        alloc.ipam, alloc.ports = IPAM(), amod.PortAllocator()
    alloc.started, alloc.went_idle = threading.Event(), threading.Event()
    alloc.errors, alloc.seen, alloc.idle_at = [], -1, -1
    spent = {"tasks": 0.0, "grants": 0.0, "order": 0.0, "calls": 0,
             "events": []}
    real_tasks = alloc._allocate_tasks

    def allocate_tasks(ids):
        t = time.perf_counter()
        try:
            return real_tasks(ids)
        finally:
            spent["tasks"] += time.perf_counter() - t

    alloc._allocate_tasks = allocate_tasks
    if mode != "scalar":
        real_many = alloc.ipam.allocate_many

        def allocate_many(net_id, k):
            i = spent["calls"]
            spent["calls"] += 1
            if rec is not None and i in ALLOC_RECORD:
                pool = alloc.ipam._pools[net_id]
                size = pool.taken.shape[0]
                rec.append((pool.taken.copy(), pool._cursor, 2, size - 2))
            t = time.perf_counter()
            try:
                return real_many(net_id, k)
            finally:
                spent["grants"] += time.perf_counter() - t

        alloc.ipam.allocate_many = allocate_many
    real_order = ga.grant_order

    def grant_order(*a, **kw):
        """The pools' grant order (batched.py calls it through the
        module): its host seconds, and on the card CUDA events around
        it (mask upload, K19, the n_free read, the positions down)."""
        if mode == "card":
            ev = [torch.cuda.Event(enable_timing=True) for _ in (0, 1)]
            ev[0].record()
        t = time.perf_counter()
        try:
            return real_order(*a, **kw)
        finally:
            spent["order"] += time.perf_counter() - t
            if mode == "card":
                ev[1].record()
                spent["events"].append(ev)

    def round2_tx(tx):
        for nid in drained:
            n = tx.get_node(nid).copy()
            n.spec.availability = NodeAvailability.DRAIN
            tx.update(n)
        for tid in gone:
            t = tx.get_task(tid).copy()
            mark_shutdown(t)
            tx.update(t)
        for n in added:
            tx.create(n)
        for t in born:
            tx.create(t)

    ga.grant_order = grant_order
    try:
        t1 = time.perf_counter()
        alloc.start()
        if not alloc.started.wait(600):
            fail(f"[alloc] {mode}: the startup pass did not finish")
        start_s = time.perf_counter() - t1
        if alloc.errors:
            fail(f"[alloc] {mode}: the startup pass failed: "
                 f"{alloc.errors[0]!r}")
        round1 = {"tasks": spent["tasks"], "grants": spent["grants"],
                  "order": spent["order"], "calls": spent["calls"]}
        wait_idle("round 1")
        t2 = time.perf_counter()
        store.update(round2_tx)
        wait_idle("round 2")
        round2_s = time.perf_counter() - t2
    finally:
        alloc.stop()
        ga.grant_order = real_order
    if alloc._thread.is_alive():
        fail(f"[alloc] {mode}: the event loop's thread did not stop")
    busy_ms = sum(a.elapsed_time(b) for a, b in spent["events"]) \
        if mode == "card" else 0.0
    tasks = {t.id: (int(t.status.state),
                    tuple(a for att in t.networks or []
                          for a in att["addresses"]))
             for t in store.view().find_tasks()}
    pool = alloc.ipam._pools["net-overlay"]
    out = dict(tasks=tasks, cursor=pool._cursor,
               allocated=frozenset(pool.allocated), restore_s=restore_s,
               start_s=start_s, round1=round1, round2_s=round2_s,
               round2_calls=spent["calls"] - round1["calls"],
               busy_ms=busy_ms, store=store)
    return out


def phase_alloc(seed, rec):
    """The allocator plane on the card: a new leader's startup allocation
    for a global service on an overlay /16 over [global]'s 50,000 nodes,
    then a round of 1% node churn on the live event loop (`alloc_run`),
    against the same scenario with the plain version (device="cpu") and
    with the scalar IPAM and PortAllocator (the per-task loop). Every task
    PENDING or terminal, no address held twice, every task's addresses,
    the pool's cursor and its allocated set equal across the three runs;
    then the global orchestrator's pass over the result plans nothing.
    Keeps K19's inputs of three startup chunks in `rec`."""
    from swarmkit_tpu_torch.api.types import TaskState
    from swarmkit_tpu_torch.orchestrator import global_ as gmod

    t_phase = time.perf_counter()
    snap, round2, build_s, orch_s, save_s = alloc_master(seed)
    N, k = ALLOC_NODES, len(round2[0])
    log(f"[alloc] set-up: store build {build_s:.4f} s ({N} nodes, one /16 "
        f"overlay, one global service); orchestrator startup pass "
        f"{orch_s:.4f} s ({N} NEW tasks through the numpy diff); snapshot "
        f"{save_s:.4f} s (host clock)")
    runs = {}
    for mode in ("card", "plain", "scalar"):
        gc.collect()
        gc.disable()          # 100,000 live objects: no collector passes
        try:
            runs[mode] = alloc_run(snap, round2, mode,
                                   rec if mode == "card" else None)
        finally:
            gc.enable()
        if mode != "card":
            del runs[mode]["store"]
    card = runs["card"]
    store = card.pop("store")
    live = [a for s, addrs in card["tasks"].values()
            if s <= int(TaskState.RUNNING) for a in addrs]
    bad = [tid for tid, (s, addrs) in card["tasks"].items()
           if not (s == int(TaskState.PENDING) and len(addrs) == 1
                   or s > int(TaskState.RUNNING) and not addrs)]
    if bad or len(card["tasks"]) != N + k:
        fail(f"[alloc] {len(bad)} tasks neither PENDING with one address "
             f"nor terminal without one (of {len(card['tasks'])}): "
             f"{bad[:3]}")
    if len(set(live)) != len(live):
        fail("[alloc] an address is held by two live tasks")
    if card["round1"]["calls"] != N // 200 or card["round2_calls"] < 1:
        fail(f"[alloc] {card['round1']['calls']} startup grants and "
             f"{card['round2_calls']} in round 2, not {N // 200} and some")
    for mode in ("plain", "scalar"):
        r = runs[mode]
        for key in ("tasks", "cursor", "allocated"):
            if r[key] != card[key]:
                diff = "" if key != "tasks" else [
                    t for t in card["tasks"]
                    if r["tasks"].get(t) != card["tasks"][t]][:3]
                fail(f"[alloc] the card run's {key} differs from the "
                     f"{mode} run's {diff}")
    version = store.version.index
    orch = gmod.GlobalOrchestrator(store)
    try:
        t0 = time.perf_counter()
        orch.bulk_reconcile(["svc-agent"])
        check_s = time.perf_counter() - t0
    finally:
        orch.stop()
    if store.version.index != version:
        fail("[alloc] the global orchestrator's pass after round 2 changed "
             "the store: round 2 was not its decision")
    for mode, r in runs.items():
        r1 = r["round1"]
        log(f"[alloc] {mode}: restore {r['restore_s']:.4f} s; startup pass "
            f"{r['start_s']:.4f} s = rebuild (reserve, network, VIP, node "
            f"attachments) {r['start_s'] - r1['tasks']:.4f} + tasks "
            f"{r1['tasks']:.4f} (grants {r1['grants']:.4f} in "
            f"{r1['calls']} calls, of which grant_order {r1['order']:.4f}; "
            f"store batches "
            f"{r1['tasks'] - r1['grants']:.4f}); round 2 "
            f"{r['round2_s']:.4f} s ({r['round2_calls']} grant calls) "
            f"(host clock)")
    wall_ms = 1e3 * (card["start_s"] + card["round2_s"])
    log(f"[alloc] {N} tasks, then {k} drained and {k} added: every task "
        f"PENDING or terminal, no address held twice, cursor "
        f"{card['cursor']}, {len(card['allocated'])} addresses held; every "
        f"address, the cursor and the allocated set equal to the plain and "
        f"the scalar runs; the orchestrator's pass after round 2 "
        f"({check_s:.4f} s) plans nothing")
    log(f"[alloc] the card: grant_order (mask upload, K19, n_free read, "
        f"positions down) {card['busy_ms']:.3f} ms between CUDA events of "
        f"the {wall_ms:.1f} ms of round 1 and round 2: idle at least "
        f"{100 * (1 - card['busy_ms'] / wall_ms):.3f}% (host-bound); the "
        f"phase {time.perf_counter() - t_phase:.1f} s")


def check_alloc_kernels(rec):
    """K19 against its plain version on the [alloc] phase's recorded
    inputs (its first, middle and last startup chunk), on a 2^20-slot pool
    (a /12) at 50% occupancy with the cursor in the middle and past hi;
    times by CUDA events and from a CUDA graph (the launch without its
    read), bound from this run's data, the library time of
    torch.argsort(stable=True) on a masked key built outside the
    timing."""
    from swarmkit_tpu_torch.device import resolve_device
    from swarmkit_tpu_torch.ops import alloc as ga

    dev = resolve_device()
    rng = np.random.default_rng(7)
    big = rng.random(1 << 20) < 0.5
    size = big.shape[0]
    cases = [(f"[alloc] chunk {c}", *r) for c, r in zip(ALLOC_RECORD, rec)]
    cases += [("/12 at 50%, cursor mid", big, size // 2, 2, size - 2),
              ("/12 at 50%, cursor past hi", big, size + 5, 2, size - 2)]
    out = {}
    for name, taken, cursor, lo, hi in cases:
        t = torch.from_numpy(taken).to(dev)
        got = ga.grant_order_tensor(t, cursor, lo, hi)
        want = ga.grant_order_plain(t, cursor, lo, hi)
        if got.shape != want.shape:
            fail(f"grant_order on {name}: {got.numel()} positions, plain "
                 f"{want.numel()}")
        err = int((got - want).abs().max()) if got.numel() else 0
        if err:
            fail(f"grant_order differs from its plain version on {name} "
                 f"(err {err})")
        ms, plain_ms = _time_pair(lambda: ga.grant_order_tensor(
            t, cursor, lo, hi), lambda: ga.grant_order_plain(
            t, cursor, lo, hi), iters=50)
        g_ms = graph_ms(lambda: ga.grant_order_launch(t, cursor, lo, hi))
        span = hi - lo + 1
        start = cursor if lo <= cursor <= hi else lo
        pos = torch.arange(lo, hi + 1, dtype=torch.int32, device=dev)
        key = torch.where(~t[lo:hi + 1],
                          torch.remainder(pos - start, span).int(), span)
        lib_ms = time_ms(lambda: torch.argsort(key, stable=True), 50)
        n_free = got.numel()
        b_ms, b_by = bound(span + 4 * n_free + 4, span)
        log(f"[kernels] grant_order on {name} (span {span}, n_free "
            f"{n_free}): equal to plain; {ms:.4f} ms a call with its read "
            f"vs plain {plain_ms:.4f} ms; graph {g_ms:.5f} ms; library "
            f"(torch.argsort stable) {lib_ms:.4f} ms; bound {b_ms:.6f} ms "
            f"({b_by})")
        out.setdefault("grant_order", dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, graph_ms=g_ms,
            shape=f"span {span}, n_free {n_free}"))
    return out


# ------------------------------------------------ the replicated services
REPL_SERVICES = 100_000       # bench.py:2288 bench_orchestrator_storm
REPL_REPLICAS = 2
REPL_WIDE = 1_000             # of them with REPL_WIDE_REPLICAS: M = 11
REPL_WIDE_REPLICAS = 10
REPL_NODES = 10_000           # the grid's nodes (bench.py:37-110)
REPL_SCALED = 100             # services scaled up by 2, and down by 1
REPL_FAILED = 0.01            # of the tasks: FAILED with desired RUNNING
REPL_DOWN = 100               # nodes set DOWN in one transaction
REPL_SAMPLE = 1_000           # steady services held against decide_service
STORM_SERVICES = 300          # bench.py:2290 storm_services x storm_replicas
STORM_REPLICAS = 5
STORM_POISON = 0.25
STORM_BUDGET_S = 120.0
REPL_BUDGET_S = 300.0         # the pump's convergence, each time


def repl_service(sid, replicas, policy=None):
    """bench.py's `mk_service`: image v1, restart delay 0.05 s, rolling
    updates 2 at a time, stop-first, a 0.3 s monitor, rollback on the
    first failure."""
    from swarmkit_tpu_torch.api.objects import Service, Version
    from swarmkit_tpu_torch.api.specs import (Annotations, ContainerSpec,
                                              RestartPolicy, ServiceSpec,
                                              TaskSpec, UpdateConfig)
    from swarmkit_tpu_torch.api.types import (UpdateFailureAction,
                                              UpdateOrder)

    svc = Service(id=sid)
    svc.spec = ServiceSpec(
        annotations=Annotations(name=sid), replicas=replicas,
        task=TaskSpec(runtime=ContainerSpec(image="v1"),
                      restart=policy or RestartPolicy(delay=0.05)),
        update=UpdateConfig(parallelism=2, delay=0.0, monitor=0.3,
                            order=UpdateOrder.STOP_FIRST,
                            failure_action=UpdateFailureAction.ROLLBACK,
                            max_failure_ratio=0.0))
    svc.spec_version = Version(1)
    return svc


def replicated_store(seed):
    """The converged cluster a new leader inherits, with its drift:
    REPL_SERVICES replicated services of REPL_REPLICAS replicas, REPL_WIDE
    of them of REPL_WIDE_REPLICAS, one RUNNING task a slot spread over
    REPL_NODES READY nodes (every seventh service restarts at most 5 times
    in 300 s, the rest without a limit); then REPL_SCALED services scaled
    up by 2 and as many down by 1, and REPL_FAILED of the tasks FAILED
    with desired RUNNING. Returns the store and the service ids."""
    from swarmkit_tpu_torch.api.objects import Node, Task, Version
    from swarmkit_tpu_torch.api.specs import RestartPolicy
    from swarmkit_tpu_torch.api.types import (NodeAvailability,
                                              NodeStatusState, TaskState)
    from swarmkit_tpu_torch.state.proposer import LocalProposer
    from swarmkit_tpu_torch.store.memory import MemoryStore

    rng = np.random.default_rng(seed)
    S, N = REPL_SERVICES, REPL_NODES
    replicas = np.full(S, REPL_REPLICAS)
    replicas[rng.choice(S, REPL_WIDE, replace=False)] = REPL_WIDE_REPLICAS
    ids = [f"rsvc-{s:06d}" for s in range(S)]
    store = MemoryStore(proposer=LocalProposer())
    limited = RestartPolicy(delay=0.05, max_attempts=5, window=300.0)

    def converged(tx):
        for i in range(N):
            n = Node(id=f"rnode-{i:05d}")
            n.status.state = NodeStatusState.READY
            n.spec.availability = NodeAvailability.ACTIVE
            tx.create(n)
        k = 0
        for s, sid in enumerate(ids):
            svc = repl_service(sid, int(replicas[s]),
                               limited if s % 7 == 0 else None)
            tx.create(svc)
            for slot in range(1, int(replicas[s]) + 1):
                t = Task(id=f"rtask-{s:06d}-{slot:02d}", service_id=sid,
                         slot=slot, node_id=f"rnode-{k % N:05d}")
                t.spec = svc.spec.task
                t.spec_version = Version(1)
                t.desired_state = TaskState.RUNNING
                t.status.state = TaskState.RUNNING
                tx.create(t)
                k += 1

    up, down = np.split(rng.choice(S, 2 * REPL_SCALED, replace=False), 2)
    n_tasks = int(replicas.sum())
    failed = set(rng.choice(n_tasks, int(n_tasks * REPL_FAILED),
                            replace=False).tolist())

    def drift(tx):
        for s, step in [(s, 2) for s in up] + [(s, -1) for s in down]:
            cur = tx.get_service(ids[s]).copy()
            cur.spec.replicas += step
            tx.update(cur)
        k = 0
        for s, sid in enumerate(ids):
            for slot in range(1, int(replicas[s]) + 1):
                if k in failed:
                    c = tx.get_task(f"rtask-{s:06d}-{slot:02d}").copy()
                    c.status.state = TaskState.FAILED
                    tx.update(c)
                k += 1

    gc.disable()
    try:
        store.update(converged)
        store.update(drift)
    finally:
        gc.enable()
    return store, ids


class AgentPump:
    """Store-side fake agents, driven by the store's watch queue: a task
    desired RUNNING that is not running yet starts (or FAILS when its
    image is the poisoned one), a task told to shut down is observed
    stopped. Each drained burst of task events is one store transaction.
    Subscribes when made; `start()` begins the work."""

    def __init__(self, store, poison):
        import threading

        from swarmkit_tpu_torch.api.objects import Task

        self.store, self.poison = store, poison
        self.ch = store.queue.watch(
            matcher=lambda e: isinstance(getattr(e, "obj", None), Task),
            limit=None)
        self.halt = threading.Event()
        self.writes = 0
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="agent-pump")

    def start(self):
        self.thread.start()

    def stop(self):
        self.halt.set()
        self.store.queue.stop_watch(self.ch)
        self.thread.join(10)

    def _act(self, t):
        from swarmkit_tpu_torch.api.types import TaskState

        if t.desired_state == TaskState.RUNNING \
                and t.status.state < TaskState.RUNNING:
            return (TaskState.FAILED if t.spec.runtime.image == self.poison
                    else TaskState.RUNNING)
        if t.desired_state >= TaskState.SHUTDOWN \
                and t.status.state <= TaskState.RUNNING:
            return TaskState.SHUTDOWN
        return None

    def _run(self):
        from swarmkit_tpu_torch.api.objects import EventDelete
        from swarmkit_tpu_torch.store.watch import ChannelClosed

        while not self.halt.is_set():
            try:
                events = [self.ch.get(timeout=0.05)] + self.ch.drain()
            except TimeoutError:
                continue
            except ChannelClosed:
                return
            todo = list(dict.fromkeys(
                e.obj.id for e in events if not isinstance(e, EventDelete)
                and self._act(e.obj) is not None))
            if not todo:
                continue

            def cb(tx):
                for tid in todo:
                    cur = tx.get_task(tid)
                    state = None if cur is None else self._act(cur)
                    if state is not None:
                        c = cur.copy()
                        c.status.state = state
                        tx.update(c)
                        self.writes += 1

            self.store.update(cb)


def replica_gate(store, down_nodes=()):
    """From the columnar mirror: services (replicated, valid) whose
    distinct runnable slots differ from their replicas; slots holding two
    tasks desired RUNNING; runnable tasks not RUNNING yet; live tasks on a
    node in `down_nodes`."""
    from swarmkit_tpu_torch.api.types import TaskState

    col = store.columnar
    with store._lock:
        n = len(col.ids)
        valid, desired, state = (col.valid[:n].copy(), col.desired[:n].copy(),
                                 col.state[:n].copy())
        svc, slot = col.service_idx[:n].astype(np.int64), col.slot[:n].copy()
        node = col.node_idx[:n].copy()
        scol = col.service_cols
        want = scol.replicas.copy()
        counted = scol.valid & scol.replicated & ~scol.pending_delete
        down = np.array([col.nodes.lookup(x) for x in down_nodes], np.int64)
    run = int(TaskState.RUNNING)
    live = valid & (desired <= run)
    runnable = live & (state <= run)
    width = int(slot.max()) + 2 if n else 1
    keys = np.unique(svc[runnable] * width + slot[runnable])
    per_service = np.bincount(keys // width, minlength=want.shape[0])
    bad = int((counted & (per_service[:want.shape[0]] != want)).sum())
    _, counts = np.unique(svc[valid & (desired == run)] * width
                          + slot[valid & (desired == run)],
                          return_counts=True)
    on_down = int((live & np.isin(node, down[down > 0])).sum())
    return bad, int((counts > 1).sum()), int((runnable & (state != run))
                                             .sum()), on_down


def wait_gate(store, what, down_nodes=()):
    t0 = time.perf_counter()
    while True:
        g = replica_gate(store, down_nodes)
        if not any(g):
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > REPL_BUDGET_S:
            fail(f"[replicated] {what}: not converged after "
                 f"{REPL_BUDGET_S:.0f} s: {g[0]} services without their "
                 f"replicas, {g[1]} slots with two tasks desired RUNNING, "
                 f"{g[2]} runnable tasks not RUNNING, {g[3]} live tasks on "
                 "down nodes")
        time.sleep(0.1)


def _norm_decision(d):
    if d is None:
        return ([], [], [], False)
    return (list(d.create_slots), list(d.victim_slots),
            [[t.id for t in ts] for ts in d.dirty_slots],
            bool(d.kick_update))


def phase_replicated(seed, rec):
    """The replicated-service reconcile path on the card (see the module
    docstring, phase 15). Keeps K18's inputs of both startup censuses in
    `rec`."""
    import copy
    import random
    import threading

    from swarmkit_tpu_torch.api.objects import Version
    from swarmkit_tpu_torch.api.types import NodeStatusState, TaskState
    from swarmkit_tpu_torch.orchestrator import batched as bmod
    from swarmkit_tpu_torch.orchestrator import replicated as rmod
    from swarmkit_tpu_torch.orchestrator import taskinit
    from swarmkit_tpu_torch.orchestrator.restart import RestartSupervisor
    from swarmkit_tpu_torch.ops import reconcile as rc
    from swarmkit_tpu_torch.store import by
    from swarmkit_tpu_torch.store.columnar import ColumnarTasks
    from swarmkit_tpu_torch.store.memory import MemoryStore
    from swarmkit_tpu_torch.utils.clock import Clock, FakeClock

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    store, ids = replicated_store(seed)
    build_s = time.perf_counter() - t0
    n_tasks = len(store.columnar.ids)
    log(f"[replicated] store build {build_s:.4f} s: {len(ids)} services "
        f"({REPL_WIDE} of {REPL_WIDE_REPLICAS} replicas, the rest of "
        f"{REPL_REPLICAS}), {n_tasks} tasks on {REPL_NODES} nodes, then "
        f"{REPL_SCALED} scaled up by 2, {REPL_SCALED} down by 1, "
        f"{int(n_tasks * REPL_FAILED)} FAILED (host clock)")

    # ---- hooks: host seconds of each part, the census on CUDA events
    spent = {"check": 0.0, "restarts": 0, "decide": 0.0, "apply": 0.0,
             "upload": 0.0, "kernel_host": 0.0, "download": 0.0,
             "kernel_ms": 0.0, "restart_many": 0.0,
             "restart_calls": 0}
    real = {"check": taskinit.check_tasks, "up": rc._census_upload,
            "kernel": rc._slot_state_kernel, "down": rc._census_download,
            "gate": bmod.batch_should_restart, "batch": store.batch}
    passes, grants = [], []
    timing = {"on": True}     # off while the plain version is compared

    def timed(key, fn, events=None):
        def run(*a, **kw):
            if not timing["on"]:
                return fn(*a, **kw)
            ev = None
            if events is not None:
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record()
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if ev is not None:
                    ev[1].record()
                    ev[1].synchronize()
                    spent[events] += ev[0].elapsed_time(ev[1])
                spent[key] += time.perf_counter() - t
        return run

    def busy_line(sp, start_s):
        copies = sp["upload"] + sp["download"]
        share = 100 * sp["kernel_ms"] / (1e3 * start_s)
        most = 100 * (sp["kernel_ms"] / 1e3 + copies) / start_s
        return (f"K18 {sp['kernel_ms']:.4f} ms between CUDA events around "
                f"its launch: the card busy {share:.4f}% of on_start, at "
                f"most {most:.4f}% with the copies' host seconds")

    def check(*a):
        fixed = real["check"](*a)
        spent["restarts"] += fixed
        return fixed

    timed_kernel = timed("kernel_host", real["kernel"], "kernel_ms")

    def kernel(*a):
        rec.append(_clone(a))       # outside the timing
        return timed_kernel(*a)

    def gate(restart, pairs, now=None):
        now = restart._clock.time() if now is None else now
        keys = {restart._instance_key(t) for _, t in pairs}
        hist = copy.deepcopy({k: v for k, v in restart._history.items()
                              if k in keys})
        out = real["gate"](restart, pairs, now)
        grants.append((list(pairs), hist, now, out.tolist()))
        return out

    class Leader(rmod.ReplicatedOrchestrator):
        """Says when its startup pass is over."""

        def on_start(self, services):
            try:
                super().on_start(services)
            finally:
                self.started.set()

    def decide_and_compare(br, cpu, sample_rng):
        """Every decide_many of `br` (on the card) is held, under the
        store's lock so that all read one snapshot, against `cpu`'s (the
        plain version), the scalar decide_service of every service it
        decided and of a seeded sample of the steady ones."""
        real_decide = br.decide_many

        def decide_many(service_ids, view=None):
            with store._lock:
                view = store.view() if view is None else view
                t = time.perf_counter()
                got = real_decide(service_ids, view=view)
                spent["decide"] += time.perf_counter() - t
                timing["on"] = False
                try:
                    want = cpu.decide_many(service_ids, view=view)
                finally:
                    timing["on"] = True
                card = {k: _norm_decision(v) for k, v in got.items()}
                if card != {k: _norm_decision(v) for k, v in want.items()}:
                    fail("[replicated] decide_many on the card differs from "
                         "decide_many with device='cpu'")
                steady = sorted(set(service_ids) - set(got))
                sample = sample_rng.sample(steady, min(REPL_SAMPLE,
                                                       len(steady)))
                for sid in list(got) + sample:
                    svc = view.get_service(sid)
                    live = [x for x in view.find_tasks(by.ByServiceID(sid))
                            if x.desired_state <= TaskState.RUNNING]
                    if _norm_decision(rmod.decide_service(svc, live)) != \
                            card.get(sid, _norm_decision(None)):
                        fail(f"[replicated] the decision for {sid} differs "
                             "from the scalar decide_service")
                passes.append(dict(decisions=len(got), sample=len(sample),
                                   actionable=sum(d.actionable
                                                  for d in got.values())))
            return got
        br.decide_many = decide_many

    def leader(tag):
        orch = Leader(store)
        orch.started = threading.Event()
        decide_and_compare(orch.batched, bmod.BatchedReconciler(
            store, device="cpu"), random.Random(seed + len(passes)))
        real_many = orch.restart.restart_many

        def restart_many(*a):
            t = time.perf_counter()
            try:
                return real_many(*a)
            finally:
                spent["restart_many"] += time.perf_counter() - t
                spent["restart_calls"] += 1
        orch.restart.restart_many = restart_many
        for k in list(spent):
            if k not in ("restart_many", "restart_calls"):
                spent[k] = 0 if k == "restarts" else 0.0
        t = time.perf_counter()
        orch.start()
        if not orch.started.wait(600):
            fail(f"[replicated] {tag}: the startup pass did not finish")
        return orch, time.perf_counter() - t

    taskinit.check_tasks = timed("check", check)
    rc._census_upload = timed("upload", real["up"])
    rc._slot_state_kernel = kernel
    rc._census_download = timed("download", real["down"])
    bmod.batch_should_restart = gate
    store.batch = timed("apply", real["batch"])
    pump = AgentPump(store, "v2-poison")
    orch = second = None
    gc.collect()
    gc.disable()          # 318,000 live objects: no collector passes
    try:
        # ---- 1-2: a new leader's startup pass, census on K18
        orch, start_s = leader("leader 1")
        s1 = dict(spent)
        if not passes or passes[0]["actionable"] < 2 * REPL_SCALED:
            fail(f"[replicated] the startup census found "
                 f"{passes and passes[0]['actionable']} actionable services, "
                 f"fewer than the {2 * REPL_SCALED} scaled ones")
        if s1["restarts"] < int(n_tasks * REPL_FAILED):
            fail(f"[replicated] check_tasks restarted {s1['restarts']} "
                 "tasks, fewer than the FAILED ones")
        log(f"[replicated] leader 1 on_start {start_s:.4f} s = check_tasks "
            f"{s1['check']:.4f} ({s1['restarts']} restarts) + decide_many "
            f"{s1['decide']:.4f} (census upload {s1['upload']:.4f}, K18 "
            f"{s1['kernel_host']:.6f}, planes' download "
            f"{s1['download']:.4f}) + apply {s1['apply']:.4f} "
            f"({passes[0]['actionable']} actionable services) (host "
            f"clock); {busy_line(s1, start_s)}")
        log(f"[replicated] leader 1's {passes[0]['decisions']} decisions "
            f"equal decide_many with device='cpu' and the scalar "
            f"decide_service, and {passes[0]['sample']} steady services "
            f"sampled are steady for decide_service too")

        # ---- 3: the agents converge the store
        pump.start()
        conv_s = wait_gate(store, "after the startup pass")
        log(f"[replicated] pump convergence {conv_s:.4f} s ({pump.writes} "
            f"agent writes): every service has its replicas in distinct "
            f"runnable slots, no slot has two tasks desired RUNNING")

        # ---- 4: 1% of the nodes DOWN in one transaction
        rng = np.random.default_rng(seed + 1)
        down = [f"rnode-{i:05d}" for i in
                rng.choice(REPL_NODES, REPL_DOWN, replace=False)]

        def set_down(tx):
            for nid in down:
                n = tx.get_node(nid).copy()
                n.status.state = NodeStatusState.DOWN
                tx.update(n)

        t = time.perf_counter()
        store.update(set_down)
        down_s = wait_gate(store, "after the node failure", down)
        waited = time.perf_counter() - t
        if spent["restart_calls"] < REPL_DOWN or not grants:
            fail(f"[replicated] restart_many ran {spent['restart_calls']} "
                 f"times for {REPL_DOWN} down nodes")
        n_pairs = n_granted = 0
        for pairs, hist, now, got in grants:
            oracle = RestartSupervisor(MemoryStore(), clock=FakeClock(now))
            oracle._history = hist
            want = []
            for svc, task in pairs:
                want.append(oracle.should_restart(task, svc))
                if want[-1]:
                    oracle._record(task, svc)
            oracle.stop()
            if want != got:
                fail("[replicated] restart_many's grants differ from "
                     "sequential should_restart calls")
            n_pairs += len(pairs)
            n_granted += sum(got)
        log(f"[replicated] {REPL_DOWN} nodes DOWN: restart_many "
            f"{spent['restart_many']:.4f} s in {spent['restart_calls']} "
            f"calls, {n_granted} of {n_pairs} restarts granted, equal to "
            f"sequential should_restart calls; converged {down_s:.4f} s "
            f"after the transaction ({waited:.4f} s with it) (host clock)")

        # ---- 5: the update storm on the live loop
        srng = random.Random(seed)
        sids = [f"storm-{i:04d}" for i in range(STORM_SERVICES)]
        poisoned = {sid for sid in sids if srng.random() < STORM_POISON}
        t = time.perf_counter()
        store.batch(lambda b: [b.update(lambda tx, sid=sid: tx.create(
            repl_service(sid, STORM_REPLICAS))) for sid in sids])

        def running(sid, image=None):
            return [x for x in store.view().find_tasks(by.ByServiceID(sid))
                    if x.desired_state <= TaskState.RUNNING
                    and x.status.state == TaskState.RUNNING
                    and (image is None or x.spec.runtime.image == image)]

        while sum(len(running(s)) for s in sids) < len(sids) * STORM_REPLICAS:
            if time.perf_counter() - t > STORM_BUDGET_S:
                fail("[replicated] the storm's services never ran v1")
            time.sleep(0.1)
        up_s = time.perf_counter() - t

        def push(b):
            for sid in sids:
                def one(tx, sid=sid):
                    new = tx.get_service(sid).copy()
                    new.previous_spec = copy.deepcopy(new.spec)
                    new.spec = copy.deepcopy(new.spec)
                    new.spec.task.runtime.image = (
                        "v2-poison" if sid in poisoned else "v2")
                    new.spec_version = Version(new.spec_version.index + 1)
                    tx.update(new)
                b.update(one)

        def converged(sid):
            svc = store.view().get_service(sid)
            want = (("rollback_completed", "v1") if sid in poisoned
                    else ("completed", "v2"))
            run = running(sid)
            return ((svc.update_status or {}).get("state") == want[0]
                    and len({x.slot for x in run}) == STORM_REPLICAS
                    and all(x.spec.runtime.image == want[1] for x in run))

        t = time.perf_counter()
        store.batch(push)
        done = set()
        while len(done) < len(sids):
            done |= {s for s in sids if s not in done and converged(s)}
            if time.perf_counter() - t > STORM_BUDGET_S:
                fail(f"[replicated] the storm converged {len(done)} of "
                     f"{len(sids)} services in {STORM_BUDGET_S:.0f} s")
            time.sleep(0.1)
        storm_s = time.perf_counter() - t
        # quiet: no commit for a second (the last restart timers and the
        # agents' answers landed) before leader 1 stops
        t = time.perf_counter()
        last = (store.version.index, time.perf_counter())
        while time.perf_counter() - last[1] < 1.0:
            if time.perf_counter() - t > STORM_BUDGET_S:
                fail("[replicated] the store never went quiet after the "
                     "storm")
            time.sleep(0.1)
            if store.version.index != last[0]:
                last = (store.version.index, time.perf_counter())
        planners = sum(th.name == "update-wave-planner"
                       for th in threading.enumerate())
        if planners != 1:
            fail(f"[replicated] {planners} planner threads ran the storm")
        stats = dict(orch.updater.planner.stats)
        log(f"[replicated] storm: {len(sids)} services x {STORM_REPLICAS} "
            f"up on v1 in {up_s:.4f} s; v2 pushed in one batch, "
            f"{len(poisoned)} poisoned rolled back to v1 "
            f"(ROLLBACK_COMPLETED), {len(sids) - len(poisoned)} COMPLETED "
            f"on v2 in {storm_s:.4f} s (host clock) on one planner thread "
            f"({stats})")
        orch.stop()
        if orch._thread.is_alive():
            fail("[replicated] leader 1's event loop did not stop")

        # ---- 6: a second leader on the converged store plans nothing
        version = store.version.index
        second, start2_s = leader("leader 2")
        s2 = dict(spent)
        if store.version.index != version or s2["restarts"] \
                or passes[-1]["decisions"]:
            fail(f"[replicated] leader 2 planned something: version "
                 f"{version} -> {store.version.index}, {s2['restarts']} "
                 f"restarts, {passes[-1]['decisions']} decisions")
        log(f"[replicated] leader 2 on the converged store: on_start "
            f"{start2_s:.4f} s = check_tasks {s2['check']:.4f} + "
            f"decide_many {s2['decide']:.4f} (census upload "
            f"{s2['upload']:.4f}, K18 {s2['kernel_host']:.6f}, download "
            f"{s2['download']:.4f}); {busy_line(s2, start2_s)}; it planned "
            f"nothing (store at version {version}), "
            f"its decisions equal device='cpu' and {passes[-1]['sample']} "
            f"sampled decide_service")
        second.stop()
        if second._thread.is_alive():
            fail("[replicated] leader 2's event loop did not stop")

        # ---- 7: the columnar mirror against a rebuild
        t = time.perf_counter()
        tasks = store.view().find_tasks()
        services = store.view().find_services()
        if not ColumnarTasks.snapshots_equal(
                store.columnar.snapshot(),
                ColumnarTasks.rebuild(tasks, services=services).snapshot()):
            fail("[replicated] the columnar mirror differs from a rebuild")
        log(f"[replicated] the columnar mirror of {len(tasks)} tasks equals "
            f"a rebuild ({time.perf_counter() - t:.4f} s); the phase "
            f"{time.perf_counter() - t_phase:.1f} s")
    finally:
        gc.enable()
        taskinit.check_tasks = real["check"]
        rc._census_upload, rc._slot_state_kernel = real["up"], real["kernel"]
        rc._census_download = real["down"]
        bmod.batch_should_restart = real["gate"]
        store.batch = real["batch"]
        for o in (orch, second):
            if o is not None:
                o.stop()
        pump.stop()
        wheel = Clock._wheel
        if wheel is not None:             # the process-wide timer service
            wheel.stop()
            if wheel._thread is not None:
                wheel._thread.join(5)
            Clock._wheel = None
    if len(rec) != 2:
        fail(f"[replicated] {len(rec)} K18 censuses, not the 2 startup "
             "passes'")


def check_replicated_kernels(rec):
    """K18 against its plain version on the two recorded startup censuses
    and on a synthetic 2^20-service x 16-slot census (3 M tasks); times
    by CUDA events through the wrapper the census calls (its checks and
    one read of the index ranges included) and, of the launch alone,
    from a CUDA graph; bound from this run's data.
    No single PyTorch call gives the three planes and the row sums: the
    library time is none."""
    from swarmkit_tpu_torch.device import resolve_device
    from swarmkit_tpu_torch.ops import reconcile as rc

    dev = resolve_device()
    rng = np.random.default_rng(11)
    S, M, T = 1 << 20, 16, 3_000_000
    synth = [torch.from_numpy(x).to(dev) for x in (
        rng.integers(0, S, T).astype(np.int32),
        rng.integers(0, M, T).astype(np.int32), rng.random(T) < 0.6,
        rng.random(T) < 0.4)]
    cases = [(f"startup census {i + 1}", *r) for i, r in enumerate(rec)]
    cases.append(("2^20 x 16", *synth, S, M))
    out = {}
    for name, sidx, slot, runnable, running, S, M in cases:
        args = (sidx, slot, runnable, running, S, M)
        got = rc.replica_slot_state(*args)
        want = rc.replica_slot_state_plain(*args)
        err = max(int((g.int() - w.int()).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        if err:
            fail(f"replica_slot_state differs from its plain version on "
                 f"{name} (err {err})")
        ms, plain_ms = _time_pair(lambda: rc.replica_slot_state(*args),
                                  lambda: rc.replica_slot_state_plain(*args))
        g_ms = graph_ms(lambda: rc._slot_state_kernel(*args))
        T = sidx.shape[0]
        b_ms, b_by = bound(10 * T + 3 * S * M + 4 * S, 3 * T + S * M)
        log(f"[kernels] replica_slot_state on {name} ({S} x {M} = {S * M} "
            f"cells, {T} tasks): equal to plain; {ms:.4f} ms vs plain "
            f"{plain_ms:.4f} ms; graph {g_ms:.5f} ms; library none; bound "
            f"{b_ms:.6f} ms ({b_by})")
        out.setdefault("replica_slot_state", dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, graph_ms=g_ms,
            shape=f"{S}x{M}, T={T}"))
    return out


# --------------------------------------------------------------- the mesh
MESH_SHARDS = 8               # the dry run's device count
MESH_SPLITS = (1, 2, MESH_SHARDS)
MESH_PARITY_NODES = 4 * MESH_SHARDS + 3   # __graft_entry__.py:74, not k-divisible
MESH_MANAGER_LOGS = (2_048, 1 << 20)      # __graft_entry__.py:167, and 2^20
MESH_NORTH = (1280 * MESH_SHARDS + 5, 101, 990)   # __graft_entry__.py:192
MESH_LOG = 1 << 15                        # __graft_entry__.py:199
SCALE_NODES = 16_384 * MESH_SHARDS        # __graft_entry__.py:231
SCALE_GPS = 2                             # groups per shard: 16 groups
SCALE_TASKS = 65_536                      # a group: 1,048,576 tasks in all


def frontier_acks(rng, managers, log_len):
    """Each manager acked a prefix of the log: random frontiers in its
    second half (the dry run's shape)."""
    fr = rng.randint(log_len // 2, log_len, managers)
    acks = np.zeros((managers, log_len), bool)
    for m in range(managers):
        acks[m, :fr[m]] = True
    return acks, fr


def mesh_parity_problems(seed):
    """random_cluster-shaped problems at 35 nodes (random labels,
    platforms, resources and plugins; small flat services) under spread,
    topology and binpack, and the dry run's example cluster (spread trees,
    ports, generic resources) under spread and binpack."""
    from swarmkit_tpu_torch.models.cluster_step import example_cluster
    from swarmkit_tpu_torch.scheduler.encode import encode

    out = []
    for i in range(3):
        rng = random.Random(seed * 100 + i)
        infos = grid_nodes(rng, MESH_PARITY_NODES)
        groups = grid_groups(i, n_services=4, per_service=16 + 8 * i)
        out.append((f"grid {i} spread", encode(infos, groups)))
        out.append((f"grid {i} topology", encode(
            infos, groups, strategy="topology", topology="node.labels.zone")))
        out.append((f"grid {i} binpack", encode(infos, groups,
                                                strategy="binpack")))
    infos, groups = example_cluster(MESH_PARITY_NODES, 7, 16, seed)
    out.append(("example spread", encode(infos, groups)))
    out.append(("example binpack", encode(infos, groups, strategy="binpack")))
    return out


def phase_mesh(seed, rec):
    """The one-shot mesh path on the card as a k-way node split: the
    placement parity, the manager-axis tally, the north-star fused step
    and the scale-out fused step with its strategy sweep
    (__graft_entry__.dryrun_multichip's stages)."""
    from swarmkit_tpu_torch.device import resolve_device
    from swarmkit_tpu_torch.models.cluster_step import (
        cluster_step,
        example_cluster,
        synth_shard_cluster,
    )
    from swarmkit_tpu_torch.ops import placement as pl
    from swarmkit_tpu_torch.ops import raft_replay as rr
    from swarmkit_tpu_torch.parallel import mesh
    from swarmkit_tpu_torch.parallel.shard_parity import (
        check_fill_invariants,
        sampled_shard_parity,
    )
    from swarmkit_tpu_torch.scheduler import batch
    from swarmkit_tpu_torch.scheduler.encode import encode, kernel_args

    dev = resolve_device()
    t_phase = time.perf_counter()
    meshes = {k: mesh.make_mesh(k) for k in MESH_SPLITS}

    # 1. placement parity: k = 1, 2, 8 over 35 nodes (3 or 5 phantoms)
    t0 = time.perf_counter()
    problems = mesh_parity_problems(seed)
    for name, p in problems:
        strategy = 1 if p.strategy == "binpack" else 0
        oracle = batch.cpu_schedule_encoded(p)
        one = pl.schedule_groups(*kernel_args(p), strategy=strategy)[0]
        if not np.array_equal(one.cpu().numpy(), oracle):
            fail(f"[mesh] {name}: the one-device counts differ from the "
                 "oracle")
        for k, m in meshes.items():
            got = mesh.sharded_schedule(p, m)
            if not np.array_equal(got, oracle):
                fail(f"[mesh] {name}: {k}-shard counts differ from the CPU "
                     "oracle and the one-device schedule_groups")
    log(f"[mesh] placement parity: {len(problems)} problems x k in "
        f"{MESH_SPLITS} at {MESH_PARITY_NODES} nodes equal to the CPU oracle "
        f"and the one-device counts ({time.perf_counter() - t0:.2f} s)")

    # 2. the manager-axis tally: one manager a shard
    rng = np.random.RandomState(seed)
    mm = mesh.make_mesh(MESH_SHARDS, axis="managers")
    fn = rr.sharded_replay_commit(mm, "managers")
    for E in MESH_MANAGER_LOGS:
        acks = rng.rand(MESH_SHARDS, E) < 0.75
        acks[:, :E // 4] |= rng.rand(MESH_SHARDS, E // 4) < 0.99
        quorum = MESH_SHARDS // 2 + 1
        commit, committed = fn(acks, quorum)
        want = _np_commit(acks, quorum)
        if int(commit) != want or not np.array_equal(
                committed.cpu().numpy(), np.arange(E) < want):
            fail(f"[mesh] manager-axis tally {MESH_SHARDS} x {E}: commit "
                 f"{int(commit)} != numpy {want}")
        rec["tally managers"] = (acks, quorum)
        log(f"[mesh] manager-axis tally {MESH_SHARDS} x {E}: commit "
            f"{want} equal to numpy")

    # 3. the north-star fused step: LMAX >= 3, ports, generic resources
    t0 = time.perf_counter()
    n_nodes, n_groups, tpg = MESH_NORTH
    p = encode(*example_cluster(n_nodes, n_groups, tpg, seed))
    t_enc = time.perf_counter() - t0
    lmax = p.spread_rank.shape[1]
    if lmax < 3 or not p.has_ports.any() or not (p.need_res[:, 2:] > 0).any():
        fail(f"[mesh] north star: LMAX {lmax}, ports "
             f"{bool(p.has_ports.any())}, generic resources: the dry run "
             "wants all three")
    acks, fr = frontier_acks(np.random.RandomState(seed + 1), N_MANAGERS,
                             MESH_LOG)
    quorum = N_MANAGERS // 2 + 1
    stats = {}
    counts, commit = mesh.sharded_cluster_step(p, acks, np.int32(quorum),
                                               meshes[MESH_SHARDS],
                                               stats=stats)
    oracle = batch.cpu_schedule_encoded(p)
    if not np.array_equal(counts, oracle):
        fail("[mesh] north star: 8-shard counts differ from the CPU oracle")
    if commit != int(np.sort(fr)[N_MANAGERS - quorum]):
        fail(f"[mesh] north star: commit {commit} != the sorted-frontier "
             f"rule {int(np.sort(fr)[N_MANAGERS - quorum])}")
    log(f"[mesh] north star: {int(counts.sum())} of "
        f"{int(p.n_tasks.sum())} tasks on {n_nodes} nodes over "
        f"{MESH_SHARDS} shards (LMAX {lmax}), equal to the CPU oracle; "
        f"commit {commit} of {MESH_LOG} equal to the sorted-frontier rule; "
        f"encode {t_enc:.2f} s, upload {stats['upload_s']:.4f} s, fill "
        f"{stats['fill_s']:.4f} s, pull {stats['pull_s']:.4f} s, H2D "
        f"{stats['h2d_bytes']} B (host clock)")

    # 4. the scale-out fused step and the strategy sweep
    acks, _ = frontier_acks(np.random.RandomState(seed + 3), N_MANAGERS,
                            MESH_LOG)
    rec["tally log"] = (acks, quorum)
    want_commit = int(rr.replay_commit(torch.from_numpy(acks).to(dev),
                                       quorum)[0])
    for strat in ("spread", "binpack", "topology"):
        t0 = time.perf_counter()
        p, gshard = synth_shard_cluster(
            SCALE_NODES, MESH_SHARDS, groups_per_shard=SCALE_GPS,
            tasks_per_group=SCALE_TASKS, seed=seed, lmax=2, strategy=strat)
        t_build = time.perf_counter() - t0
        rec[f"scale {strat}"] = p
        s = 1 if strat == "binpack" else 0
        # 8 shards twice (the first call of the strategy's shapes in the
        # process, then again), then 1 shard
        runs = []
        for k in (MESH_SHARDS, MESH_SHARDS, 1):
            stats = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            counts, commit = mesh.sharded_cluster_step(
                p, acks, np.int32(quorum), meshes[k], stats=stats)
            runs.append((counts, time.perf_counter() - t0, stats))
            if commit != want_commit:
                fail(f"[mesh] scale-out {strat}, {k} shards: commit "
                     f"{commit} != replay_commit {want_commit}")
        t0 = time.perf_counter()
        single = cluster_step(torch.from_numpy(acks).to(dev), quorum,
                              *kernel_args(p), strategy=s)
        if int(single[2]) != want_commit:
            fail(f"[mesh] scale-out {strat}: the one-device cluster_step's "
                 "commit differs")
        single = single[0].cpu().numpy()
        t_single = time.perf_counter() - t0
        counts = runs[0][0]
        if not all(np.array_equal(counts, c) for c in
                   (runs[1][0], runs[2][0], single)):
            fail(f"[mesh] scale-out {strat}: 8-shard, 1-shard and "
                 "one-device counts differ")
        t0 = time.perf_counter()
        inv = check_fill_invariants(p, counts)
        checked = sampled_shard_parity(p, counts, gshard, MESH_SHARDS, 2)
        t_check = time.perf_counter() - t0
        split = [f"{wall:.4f} s = upload {st['upload_s']:.4f} + fill "
                 f"{st['fill_s']:.4f} + pull {st['pull_s']:.4f}"
                 for _, wall, st in runs]
        st = runs[0][2]
        log(f"[mesh] scale-out {strat}: {inv['placed']} of {inv['tasks']} "
            f"tasks on {inv['nodes']} nodes, {inv['groups']} groups; "
            f"8-shard = 1-shard = one-device cluster_step counts; commit "
            f"{want_commit} = replay_commit; invariants and sampled-shard "
            f"parity on shards {checked} ok ({t_check:.2f} s); 8 shards "
            f"(H2D {st['h2d_bytes']} B, D2H {st['d2h_bytes']} B): first "
            f"{split[0]}, again {split[1]}; 1 shard {split[2]}; one-device "
            f"cluster_step {t_single:.4f} s; build {t_build:.2f} s (host "
            f"clock)")
    log(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s")


def _step_ms(step, tables, fresh, G, reps):
    """Mean device ms per group step: G steps from fresh states, by CUDA
    events, over `reps` runs."""
    total = 0.0
    for _ in range(reps):
        states = fresh()
        outs = [torch.zeros((G, t.mask.shape[1]), dtype=torch.int32,
                            device=t.mask.device) for t in tables]
        flags = torch.zeros(G, dtype=torch.int32, device=tables[0].mask.device)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for g in range(G):
            step(tables, states, g, outs, flags)
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / (reps * G)


def _step_host_ns(step, tables, fresh, G, reps=5):
    """Host ns per group step: the G steps from fresh states by the host
    clock (the card synchronised before and after), over `reps` runs."""
    total = 0
    for _ in range(reps):
        states = fresh()
        outs = [torch.zeros((G, t.mask.shape[1]), dtype=torch.int32,
                            device=t.mask.device) for t in tables]
        flags = torch.zeros(G, dtype=torch.int32, device=tables[0].mask.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for g in range(G):
            step(tables, states, g, outs, flags)
        torch.cuda.synchronize()
        total += time.perf_counter_ns() - t0
    return total / (reps * G)


def _loop_ms(strategy, tables, fresh, G, nb, reps=5):
    """Mean ms a step of the launch loop as the main path runs it
    (`parallel.fill.sharded_fill`: its counts and flags, then one step a
    group), from fresh states: (CUDA events, host ns) over `reps` runs."""
    from swarmkit_tpu_torch.parallel import fill

    ev, ns = 0.0, 0
    for _ in range(reps):
        states = fresh()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter_ns()
        e0.record()
        fill.sharded_fill(tables, states, strategy, nb)
        e1.record()
        e1.synchronize()
        ns += time.perf_counter_ns() - t0
        ev += e0.elapsed_time(e1)
    return ev / (reps * G), ns / (reps * G)


def _joined(tables, states):
    """One-device FillTables and FillState of the shards joined on the node
    axis (the group-side tables as they are)."""
    from swarmkit_tpu_torch.ops.placement import FillState, FillTables

    axis = {"mask": 1, "penalty": 1, "spread_rank": 2}
    t = FillTables(*(torch.cat([getattr(x, f) for x in tables], axis[f])
                     if f in axis else getattr(tables[0], f)
                     for f in FillTables._fields))
    st = FillState(*(torch.cat([getattr(x, f) for x in states],
                               1 if f == "svc_counts" else 0)
                     for f in FillState._fields))
    return t, st


def _graph_step_ms(step, tables, fresh, G, reps=5):
    """Mean device ms per group step from a CUDA graph of the G steps and
    the copies that restore the state before them (the steps fold it in
    place); the copies are a few MB, microseconds beside the steps."""
    pristine = fresh()
    states = fresh()
    dev = tables[0].mask.device
    outs = [torch.zeros((G, t.mask.shape[1]), dtype=torch.int32, device=dev)
            for t in tables]
    flags = torch.zeros(G, dtype=torch.int32, device=dev)

    def run():
        for st, src in zip(states, pristine):
            for a, b in zip(st, src):
                a.copy_(b)
        for g in range(G):
            step(tables, states, g, outs, flags)

    return graph_ms(run, iters=1, reps=reps) / G


def _check_sharded_fill(name, where, tables, base, nb, ops_fill=None):
    """K20 (spread, topology), or K21 (binpack: `ops_fill` its operations a
    node), against its plain version over every group of `tables` from
    fresh copies of the shard states `base`; fails unless the counts, the
    carries and the flags agree. Then ms a step by CUDA events, from a
    CUDA graph and by the host clock, a call of the wrapper alone and in
    the launch loop as the main path runs it (K21's loop checks its
    inputs once), the plain version's, the bound from these shapes, and
    how the step launches (K21 also its key route on these inputs).
    Returns the kernels-line row."""
    from swarmkit_tpu_torch.ops.placement import FillState
    from swarmkit_tpu_torch.parallel import fill

    if ops_fill is None:
        step = functools.partial(fill.sharded_water_fill_step,
                                 n_branches=nb)
        plain = fill.sharded_water_fill_step_plain
    else:
        step = fill.sharded_binpack_fill_step
        plain = fill.sharded_binpack_fill_step_plain

    def fresh():
        return [FillState(*(x.clone() for x in st)) for st in base]
    G = tables[0].n_tasks.shape[0]
    got_s, want_s = fresh(), fresh()
    got, f_k = fill.sharded_fill(tables, got_s, 0 if ops_fill is None
                                 else 1, nb)
    want = [torch.zeros_like(c) for c in got]
    f_p = torch.zeros_like(f_k)
    for g in range(G):
        plain(tables, want_s, g, want, f_p)
    err = max(int((a - b).abs().max()) for a, b in zip(got, want))
    for a, b in zip(got_s, want_s):
        err = max([err] + [int((x.int() - y.int()).abs().max())
                           for x, y in zip(a, b)])
    if err or f_k.any() or f_p.any():
        fail(f"{name} differs from its plain version on {where} (err {err}, "
             f"flags {f_k.tolist()} / {f_p.tolist()})")
    _step_ms(step, tables, fresh, G, 1)                # warm-up
    ms = _step_ms(step, tables, fresh, G, 5)
    g_ms = _graph_step_ms(step, tables, fresh, G)
    ns = _step_host_ns(step, tables, fresh, G)
    _loop_ms(0 if ops_fill is None else 1, tables, fresh, G, nb, 1)
    loop_ms, loop_ns = _loop_ms(0 if ops_fill is None else 1, tables, fresh,
                                G, nb)
    plain_ms = _step_ms(plain, tables, fresh, G, 1)
    k, n = len(tables), tables[0].mask.shape[1]
    N = k * n
    R, PV = tables[0].need_res.shape[1], tables[0].group_ports.shape[1]
    lmax = 0 if ops_fill is not None else tables[0].spread_rank.shape[1]
    b_ms, b_by = fill_bound(N, R, PV, lmax, ops_fill)
    slots = f", {nb} branch slots" if ops_fill is None else ""
    if ops_fill is None:
        plan = fill_launch(N, nb, k)
    else:
        plan = fill_launch(N, k=k, name="sharded_binpack_fill")
        plan["keys"] = binpack_keys(*_joined(tables, fresh()), range(G))
    launch = f"; {_launch_text(plan)}" + (
        f"; {plan['keys']}" if "keys" in plan else "")
    log(f"[kernels] {name} on {where} ({k} shards x {n} nodes, LMAX "
        f"{lmax}{slots}): equal to plain over {G} steps; {ms:.4f} ms/launch, "
        f"graph {g_ms:.4f} ms, host ns a step {ns:.0f}; in the launch loop "
        f"(sharded_fill) {loop_ms:.4f} ms a step, host ns {loop_ns:.0f}; vs "
        f"plain {plain_ms:.4f} ms; library none; bound {b_ms:.5f} ms "
        f"({b_by}){launch}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, graph_ms=g_ms, host_ns=ns,
                loop_ms=loop_ms, loop_host_ns=loop_ns,
                shape=f"{k}x{n}, G={G}, LMAX {lmax}", launch=plan)


def check_mesh_one_device(p, strategy):
    """K3 (spread) or K9 (binpack) at [mesh]'s one-device comparison: the
    scale-out problem (131,072 nodes; spread LMAX 2) as the one-device
    cluster_step runs it, every group against the plain version; CUDA
    events and a CUDA graph."""
    from swarmkit_tpu_torch.convert import (
        check_kernel_args,
        kernel_args_from_arrays,
    )
    from swarmkit_tpu_torch.device import resolve_device
    from swarmkit_tpu_torch.ops import placement as pl
    from swarmkit_tpu_torch.scheduler.encode import kernel_args

    args = kernel_args_from_arrays(kernel_args(p), resolve_device())
    dims = check_kernel_args(args)
    mask = pl.static_mask(*[args[i] for i in (0, 1, 2, 3, 5, 6, 7, 4, 20)])
    if strategy == "binpack":
        step = getattr(pl.binpack_fill_step, "real", pl.binpack_fill_step)
        return check_fill("the scale-out binpack, one device", args, dims,
                          mask, step, pl.binpack_fill_step_plain, 0,
                          ops_per_node=11, launch="binpack_fill")
    step = getattr(pl.tree_fill_step, "real", pl.tree_fill_step)
    return check_fill("the scale-out spread, one device", args, dims, mask,
                      step, pl.tree_fill_step_plain, dims["L"],
                      launch="tree_fill")


def check_mesh_kernels(rec):
    """K20-K22 and the sharded K1 against their plain versions on the
    [mesh] phase's scale-out inputs (131,072 nodes over 8 shards, 16
    groups; the manager-axis 8 x 2^20 acks; the log-split 5 x 2^15 acks);
    times by CUDA events per launch, from a CUDA graph and (K1, K20, K21)
    by the host clock; bound from this run's shapes. No single PyTorch
    call computes them: the library time is none."""
    from swarmkit_tpu_torch.device import resolve_device
    from swarmkit_tpu_torch.ops import raft_replay as rr
    from swarmkit_tpu_torch.parallel import fill, mesh

    dev = resolve_device()
    m = mesh.make_mesh(MESH_SHARDS)
    out = {}
    for name, key, ops_fill in (("sharded_water_fill_step", "scale spread",
                                 None),
                                ("sharded_binpack_fill_step",
                                 "scale binpack", 11)):
        args, _ = mesh.shard_problem(rec[key], m)
        tables, base, nb = fill.fill_inputs(args)
        out[name] = _check_sharded_fill(
            name, f"the scale-out {key.split()[1]}", tables, base, nb,
            ops_fill)
        if ops_fill is None:      # K1 over the 8 shards: 8 x 16,384 x 16
            out["sharded_static_mask"] = check_sharded_mask(
                "the scale-out spread", [args[i] for i in MASK_ARGS])
    out["tree_fill_step mesh"] = check_mesh_one_device(rec["scale spread"],
                                                       "spread")
    out["binpack_fill_step mesh"] = check_mesh_one_device(
        rec["scale binpack"], "binpack")

    rows = []
    for layout, key in (("managers", "tally managers"), ("log", "tally log")):
        acks, quorum = rec[key]
        M, E = acks.shape
        k = MESH_SHARDS
        if layout == "log":
            acks = np.pad(acks, ((0, 0), (0, (-E) % k)))
        t = torch.from_numpy(acks)
        dim = 0 if layout == "managers" else 1
        parts = [s.contiguous().to(dev)
                 for s in torch.split(t, t.shape[dim] // k, dim)]
        q = torch.tensor(quorum, dtype=torch.int32, device=dev)
        gc, gm = rr.sharded_replay_tally(parts, q, layout)
        pc, pm = rr.sharded_replay_tally_plain(parts, q, layout)
        if layout == "log":
            gm, pm = torch.cat(gm), torch.cat(pm)
        err = max(abs(int(gc) - int(pc)), int((gm.int() - pm.int())
                                              .abs().max()))
        if err:
            fail(f"sharded_replay_tally ({layout}) differs from its plain "
                 f"version (err {err})")
        ms, plain_ms = _time_pair(
            lambda: rr.sharded_replay_tally(parts, q, layout),
            lambda: rr.sharded_replay_tally_plain(parts, q, layout))
        g_ms = graph_ms(lambda: rr.sharded_replay_tally(parts, q, layout)) \
            if layout == "managers" else None
        b_ms, b_by = bound(M * acks.shape[1] + acks.shape[1] + 8,
                           2 * M * acks.shape[1])
        log(f"[kernels] sharded_replay_tally, {layout} split ({k} shards, "
            f"{M} x {acks.shape[1]}, commit {int(gc)}): equal to plain; "
            f"{ms:.4f} ms a call vs plain {plain_ms:.4f} ms; graph "
            f"{'not measured (a log call allocates its outputs anew, so its pointer table is uploaded in the call)' if g_ms is None else f'{g_ms:.5f} ms'}; "
            f"library none; bound {b_ms:.6f} ms ({b_by})")
        rows.append(dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None,
                         graph_ms=g_ms, shape=f"{layout} {M}x{acks.shape[1]}"))
    out["sharded_replay_tally"] = rows[0]
    return out


# ------------------------------------------------- the mesh resident tick
def phase_mesh_resident(seed, rec, ref):
    """The resident tick with its carry node-sharded over MESH_SHARDS
    shards of the card (MeshResidentPlacement under TickPipeline): phase
    8's grid and node-heavy runs (a cold tick, 8 pipelined waves, task
    completions before wave 7, invalidate() before wave 8), each with the
    async and then the synchronous commit. Every wave's counts, the
    NodeInfos after the flush and the joined carry equal the one-device
    tick's async run of phase 8 (`ref`); both pull forms are taken."""
    from swarmkit_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    m = make_mesh(MESH_SHARDS)
    pulls = {"dense": 0, "sparse": 0}
    rec.active = True
    for name, n_nodes, node_seed, per_service, wave0 in (
            ("grid", N_NODES, seed + 1, TASKS_PER_GROUP, 100),
            ("node-heavy", HEAVY_NODES, seed + 2, HEAVY_PER_SERVICE, 200)):
        want_counts, want_infos, want_carry = ref[name]
        for mode in ("async", "sync"):
            infos = grid_nodes(random.Random(node_seed), n_nodes)
            run = f"{name} mesh {mode}"
            rp, _ = steady_run(
                run, rec, infos,
                lambda w, wave0=wave0, per=per_service: grid_groups(
                    wave0 + w, N_GROUPS, per),
                STEADY_WAVES, churn_at=7, invalidate_at=8,
                async_commit=mode == "async", record=False, mesh=m,
                against=want_counts)
            if [info_state(i) for i in infos] != want_infos:
                fail(f"[mesh_resident] {run}: NodeInfos after the flush "
                     "differ from the one-device tick's")
            st = rp.pull_state()
            bad = [f for f in want_carry
                   if st[f].shape != want_carry[f].shape
                   or not np.array_equal(st[f], want_carry[f])]
            if bad:
                fail(f"[mesh_resident] {run}: joined carry differs from the "
                     f"one-device tick's in {bad}")
            widths = {tuple(t.shape) for t in rp._state[0]}
            for k in pulls:
                pulls[k] += rp.pulls[k]
            log(f"[mesh_resident] {run}: counts equal to the one-device "
                f"tick's wave for wave, {len(want_infos)} NodeInfos and the "
                f"joined carry equal after the flush; {MESH_SHARDS} shards "
                f"of {sorted(widths)} nodes; pulls {rp.pulls}, uploads "
                f"{rp.uploads_svc}, delta rows {rp.uploads_delta_rows}")
            del rp, infos
    rec.active = False
    if not all(pulls.values()):
        fail(f"[mesh_resident] a pull form was not taken: {pulls}")
    log(f"[mesh_resident] pulls {pulls}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")


def check_mesh_resident_kernels(rec):
    """K23, K24, K20 and the sharded K1 against their plain versions on
    the inputs recorded in [mesh_resident] (the grid's churn tick; a grid
    tick's dense pull and a node-heavy tick's sparse pull; the grid's
    cold-tick fill and mask); times by CUDA events and from a CUDA graph,
    K24's in turns with its library calls by both clocks."""
    from swarmkit_tpu_torch.ops import resident_mesh as rm
    from swarmkit_tpu_torch.parallel import fill

    out = {}
    missing = [k for k in ("sharded_delta_scatter",
                           "sharded_counts_pull dense",
                           "sharded_counts_pull sparse", "sharded_fill",
                           "sharded_static_mask")
               if k not in rec.calls]
    if missing:
        fail(f"[mesh_resident] no call recorded: {missing}")
    # K23: the recorded carry and rows; a pointer table of the copies
    state, deltas, _table = rec.calls["sharded_delta_scatter"]
    got = _clone(state)
    want = _clone(state)
    table = rm.scatter_table(got)
    rm.sharded_delta_scatter.real(got, deltas, table)
    rm.sharded_delta_scatter_plain(want, deltas)
    err = max(int((a.int() - b.int()).abs().max()) if a.numel() else 0
              for fa, fb in zip(got, want) for a, b in zip(fa, fb))
    if err:
        fail(f"sharded_delta_scatter differs from its plain version ({err})")
    ms, plain_ms = _time_pair(
        lambda: rm.sharded_delta_scatter.real(got, deltas, table),
        lambda: rm.sharded_delta_scatter_plain(want, deltas))
    g_ms = graph_ms(lambda: rm.sharded_delta_scatter.real(got, deltas,
                                                           table))
    D, k = deltas[0].shape[0], len(state[0])
    row = sum(d[:1].numel() * d.element_size() for d in deltas[1:8]) \
        + deltas[8].shape[0] * 4
    b_ms, b_by = bound(D * (4 + 2 * row), 0)
    n = state[0][0].shape[0]
    log(f"[kernels] sharded_delta_scatter (D={D} into {k} x {n}): equal to "
        f"plain; {ms:.4f} ms, graph {g_ms:.5f} ms vs plain {plain_ms:.4f} "
        f"ms; library none; bound {b_ms:.6f} ms ({b_by})")
    out["sharded_delta_scatter"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, graph_ms=g_ms,
        shape=f"D={D}, {k}x{n}")

    # K24: the dense and the sparse form, each in turns with its library
    # call
    rows = {}
    for form in ("dense", "sparse"):
        args = rec.calls[f"sharded_counts_pull {form}"]
        counts, g, n, compact = args[:4]
        kk = args[4] if form == "sparse" else None
        got = rm.sharded_counts_pull.real(*args)
        want = rm.sharded_counts_pull_plain(*args)
        pairs = [(got, want)] if kk is None else list(zip(got, want))
        err = max(int((a.int() - b.int()).abs().max()) for a, b in pairs)
        if err or any(a.dtype != b.dtype for a, b in pairs):
            fail(f"sharded_counts_pull ({form}) differs from its plain "
                 "version")

        def kernel(args=args):
            return rm.sharded_counts_pull.real(*args)

        g_ms = graph_ms(kernel)
        dt = torch.int16 if compact else torch.int32
        vb = 2 if compact else 4
        if kk is None:
            def library(counts=counts, g=g, n=n, dt=dt):
                return torch.cat(counts, 1)[:g, :n].to(dt)
            b_ms, b_by = bound(g * n * (4 + vb), 0)
            path = ("vector" if rm.pull_vector(
                [c.data_ptr() for c in counts], got.data_ptr(), n,
                counts[0].shape[1]) else "scalar") + " path, "
        else:
            joined = torch.cat(counts, 1).contiguous()

            def library(joined=joined, g=g, n=n, kk=kk):
                flat = joined[:g, :n].reshape(-1)
                nz = torch.nonzero_static(flat, size=kk,
                                          fill_value=0).reshape(-1)
                return nz, flat[nz]
            b_ms, b_by = bound(g * n * 4 + kk * (4 + vb), g * n)
            path = ""
        lib = library()
        same = (torch.equal(lib.int(), got.int()) if kk is None else
                torch.equal(lib[0].int(), got[0])
                and torch.equal(lib[1].int(), got[1].int()))
        if not same:
            fail(f"the library call does not compute sharded_counts_pull "
                 f"({form})")
        ms, lib_ms, turns = time_turns(kernel, library)
        plain_ms = time_ms(lambda: rm.sharded_counts_pull_plain(*args), 20)
        ns, lib_ns, ns_turns = host_turns(kernel, library)
        lib_g_ms = graph_ms(library)
        shape = (f"{g}x{n} of {len(counts)} x {tuple(counts[0].shape)}, "
                 f"{dt}" + ("" if kk is None else f", kk={kk}"))
        log(f"[kernels] sharded_counts_pull {form} ({shape}, {path}equal to "
            f"plain): {ms:.4f} ms, graph {g_ms:.5f} ms vs plain "
            f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms (in turns, kernel "
            f"/ library: {_turns_text(turns)}); host ns a call {ns:.0f} vs "
            f"library {lib_ns:.0f} (in turns: {_ns_turns_text(ns_turns)}); "
            f"library graph {lib_g_ms:.5f} ms; bound {b_ms:.6f} ms ({b_by})")
        rows[form] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                          graph_ms=g_ms, library_graph_ms=lib_g_ms,
                          turns_ms=turns, host_ns=ns, library_host_ns=lib_ns,
                          host_ns_turns=ns_turns, shape=shape)
    out["sharded_counts_pull"] = dict(rows["dense"], sparse=rows["sparse"],
                                      max_abs_err=max(
                                          r["max_abs_err"]
                                          for r in rows.values()))

    # K20 at the mesh tick's grid shape: the groups of the recorded first
    # spread fill (the grid's cold tick), from fresh copies of its carry
    tables, states, _, nb = rec.calls["sharded_fill"]
    # the recording copied each shard's tables apart: share the group-side
    # ones again, as the step requires
    tables = [t._replace(**{f: getattr(tables[0], f)
                            for f in fill._GROUP_FIELDS}) for t in tables]
    out["sharded_water_fill_step mesh_resident"] = _check_sharded_fill(
        "sharded_water_fill_step", "the mesh tick's grid", tables, states,
        nb)
    # K1 over the 8 shards of the grid's cold tick: 8 x 2,048 x 20
    out["sharded_static_mask mesh_resident"] = check_sharded_mask(
        "the mesh tick's grid", list(rec.calls["sharded_static_mask"]))
    return out


SOURCES = {
    "static_mask": ("swarmkit_tpu_torch/csrc/static_mask.cu",
                    "swarmkit_tpu/ops/placement.py:67"),
    "sharded_static_mask": ("swarmkit_tpu_torch/csrc/static_mask.cu",
                            "swarmkit_tpu/ops/placement.py:67"),
    "flat_fill_step": ("swarmkit_tpu_torch/csrc/flat_fill.cu",
                       "swarmkit_tpu/ops/placement.py:173"),
    "tree_fill_step": ("swarmkit_tpu_torch/csrc/tree_fill.cu",
                       "swarmkit_tpu/ops/placement.py:209"),
    "replay_commit": ("swarmkit_tpu_torch/csrc/replay_commit.cu",
                      "swarmkit_tpu/ops/raft_replay.py:34"),
    "resident_delta_scatter": (
        "swarmkit_tpu_torch/csrc/resident_delta_scatter.cu",
        "swarmkit_tpu/ops/resident.py:84"),
    "counts_window": ("swarmkit_tpu_torch/csrc/counts_window.cu",
                      "swarmkit_tpu/ops/resident.py:162"),
    "sparse_counts": ("swarmkit_tpu_torch/csrc/sparse_counts.cu",
                      "swarmkit_tpu/ops/resident.py:170"),
    "svc_matrix_build": ("swarmkit_tpu_torch/csrc/svc_matrix_build.cu",
                         "swarmkit_tpu/ops/resident.py:150"),
    "binpack_fill_step": ("swarmkit_tpu_torch/csrc/binpack_fill.cu",
                          "swarmkit_tpu/ops/placement.py:285"),
    "unpack_bits": ("swarmkit_tpu_torch/csrc/unpack_bits.cu",
                    "swarmkit_tpu/ops/bitpack.py:26"),
    "frontier_advance_burst": ("swarmkit_tpu_torch/csrc/frontier_advance.cu",
                               "swarmkit_tpu/ops/raft_replay.py:95"),
    "match_index_commit": ("swarmkit_tpu_torch/csrc/match_index_commit.cu",
                           "swarmkit_tpu/ops/raft_replay.py:118"),
    "replay_log_scan": ("swarmkit_tpu_torch/csrc/replay_log_scan.cu",
                        "swarmkit_tpu/ops/raft_replay.py:126"),
    "global_diff": ("swarmkit_tpu_torch/csrc/global_diff.cu",
                    "swarmkit_tpu/ops/reconcile.py:34"),
    "diff_compact": ("swarmkit_tpu_torch/csrc/diff_compact.cu",
                     "swarmkit_tpu/ops/reconcile.py:58"),
    "task_count_flat": ("swarmkit_tpu_torch/csrc/task_count_flat.cu",
                        "swarmkit_tpu/ops/reconcile.py:99"),
    "global_diff_churn_burst": ("swarmkit_tpu_torch/csrc/churn_burst.cu",
                                "swarmkit_tpu/ops/reconcile.py:136"),
    "grant_order": ("swarmkit_tpu_torch/csrc/grant_order.cu",
                    "swarmkit_tpu/ops/alloc.py:45"),
    "replica_slot_state": ("swarmkit_tpu_torch/csrc/replica_slot_state.cu",
                           "swarmkit_tpu/ops/reconcile.py:202"),
    "sharded_water_fill_step": (
        "swarmkit_tpu_torch/csrc/sharded_water_fill.cu",
        "swarmkit_tpu/parallel/mesh.py:276"),
    "sharded_binpack_fill_step": (
        "swarmkit_tpu_torch/csrc/sharded_binpack_fill.cu",
        "swarmkit_tpu/parallel/mesh.py:276"),
    "sharded_replay_tally": ("swarmkit_tpu_torch/csrc/sharded_replay_tally.cu",
                             "swarmkit_tpu/ops/raft_replay.py:46"),
    "sharded_delta_scatter": (
        "swarmkit_tpu_torch/csrc/sharded_delta_scatter.cu",
        "swarmkit_tpu/ops/resident.py:126"),
    "sharded_counts_pull": ("swarmkit_tpu_torch/csrc/sharded_counts_pull.cu",
                            "swarmkit_tpu/ops/resident.py:162"),
}
# the kernels each main path must launch
PATHS = {"waves+flagship": ("static_mask", "flat_fill_step",
                            "tree_fill_step", "replay_commit"),
         "binpack": ("static_mask", "binpack_fill_step", "replay_commit"),
         "steady": ("static_mask", "flat_fill_step", "tree_fill_step",
                    "binpack_fill_step", "resident_delta_scatter",
                    "counts_window", "sparse_counts", "svc_matrix_build"),
         "replay": ("unpack_bits", "replay_commit", "frontier_advance_burst",
                    "match_index_commit", "replay_log_scan"),
         "int32": ("static_mask", "flat_fill_step", "sparse_counts",
                   "svc_matrix_build"),
         "global": ("global_diff",),
         "reconcile": ("unpack_bits", "task_count_flat",
                       "global_diff_churn_burst", "global_diff",
                       "diff_compact"),
         "alloc": ("grant_order",),
         "replicated": ("replica_slot_state",),
         "mesh": ("static_mask", "sharded_static_mask",
                  "sharded_water_fill_step", "sharded_binpack_fill_step",
                  "sharded_replay_tally"),
         "mesh_resident": ("sharded_static_mask", "sharded_water_fill_step",
                           "svc_matrix_build", "sharded_delta_scatter",
                           "sharded_counts_pull")}


def drive(path, wrappers, run) -> dict:
    """Run one main path with every launch count set to 0 just before it;
    fails unless each of the path's kernels launched."""
    for w in wrappers.values():
        w.launches = 0
    run()
    launches = {k: w.launches for k, w in wrappers.items()}
    missing = [k for k in PATHS[path] if launches[k] == 0]
    if missing:
        fail(f"kernels not launched on the {path} path: {missing}")
    log(f"[launches] {path} path: {launches}")
    return launches


def mask_only(seed) -> None:
    """K1 alone (`--mask-only`), on inputs of the shapes the full run
    records: the flagship's 20 x 10,000 (the same problem as [kernels]),
    [mesh]'s scale-out over 8 shards of 16,384 with 16 groups (the same
    problem as [mesh]), and a 16,384-node grid with 20 groups over 8
    shards of 2,048 (the mesh tick's shape; the tick pads 10,000 nodes
    with phantoms). The one-device call, the per-shard route (k one-device
    calls) and, where the port has it, the sharded call, each by CUDA
    events, from a CUDA graph and by the host clock. It needs only
    `static_mask` and the mesh's `shard_problem`, so one chip call can
    time a parent revision and its change side by side; prints one JSON
    line {"mask_only": {...}}."""
    from swarmkit_tpu_torch.convert import kernel_args_from_arrays
    from swarmkit_tpu_torch.device import resolve_device
    from swarmkit_tpu_torch.models.cluster_step import (
        example_cluster,
        synth_shard_cluster,
    )
    from swarmkit_tpu_torch.ops import _kernels
    from swarmkit_tpu_torch.ops import placement as pl
    from swarmkit_tpu_torch.parallel import mesh
    from swarmkit_tpu_torch.scheduler.encode import encode, kernel_args

    dev = resolve_device()
    _kernels.build(["static_mask"])
    flag = kernel_args_from_arrays(kernel_args(encode(*example_cluster(
        N_NODES, N_GROUPS, TASKS_PER_GROUP, seed))), dev)
    one = [flag[i] for i in MASK_ARGS]
    m = mesh.make_mesh(MESH_SHARDS)
    scale, _ = synth_shard_cluster(
        SCALE_NODES, MESH_SHARDS, groups_per_shard=SCALE_GPS,
        tasks_per_group=SCALE_TASKS, seed=seed, lmax=2, strategy="spread")
    grid = encode(grid_nodes(random.Random(seed + 1), 2_048 * MESH_SHARDS),
                  grid_groups(100))

    def timed(fn):
        return dict(ms=time_ms(fn, 200), graph_ms=graph_ms(fn),
                    host_ns=host_ns(fn))

    out = {f"one {N_GROUPS}x{N_NODES}": timed(lambda: pl.static_mask(*one))}
    for p in (scale, grid):
        sharded = mesh.shard_problem(p, m)[0]
        args = [sharded[i] for i in MASK_ARGS]
        G, n = args[7][0].shape
        shape = f"{MESH_SHARDS}x{G}x{n}"
        shards = [_shard_mask_args(args, b) for b in range(MESH_SHARDS)]
        want = [pl.static_mask_plain(*a) for a in shards]
        if not all(torch.equal(pl.static_mask(*a), w)
                   for a, w in zip(shards, want)):
            fail(f"static_mask differs from its plain version at {shape}")
        out[f"per_shard {shape}"] = timed(
            lambda: [pl.static_mask(*a) for a in shards])
        if hasattr(pl, "sharded_static_mask"):
            if not all(torch.equal(a, w) for a, w in zip(
                    pl.sharded_static_mask(*args), want)):
                fail(f"sharded_static_mask differs from its plain version "
                     f"at {shape}")
            out[f"sharded {shape}"] = timed(
                lambda: pl.sharded_static_mask(*args))
    for key, row in out.items():
        log(f"[mask] {key}: {row['ms']:.4f} ms, graph "
            f"{row['graph_ms']:.5f} ms, host ns a call {row['host_ns']:.0f}")
    print(json.dumps({"mask_only": out}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mask-only", action="store_true",
                    help="time K1 alone (see mask_only) and stop")
    opts = ap.parse_args()
    seed = opts.seed
    t_start = time.perf_counter()
    kind, count = phase_device()
    if opts.mask_only:
        mask_only(seed)
        return 0
    try:
        from swarmkit_tpu_torch.ops import alloc as ga
        from swarmkit_tpu_torch.ops import bitpack as bp
        from swarmkit_tpu_torch.ops import placement as pl
        from swarmkit_tpu_torch.ops import raft_replay as rr
        from swarmkit_tpu_torch.ops import reconcile as rc
        from swarmkit_tpu_torch.ops import resident as rs
        from swarmkit_tpu_torch.ops import resident_mesh as rm
        from swarmkit_tpu_torch.parallel import fill as mf
    except ImportError as e:
        fail(f"the port is not importable here: {e}")
    phase_build()
    results, flag_p = phase_kernels(seed)

    wrappers = {"static_mask": pl.static_mask,
                "sharded_static_mask": pl.sharded_static_mask,
                "flat_fill_step": pl.flat_fill_step,
                "tree_fill_step": pl.tree_fill_step,
                "replay_commit": rr.replay_commit,
                "resident_delta_scatter": rs.resident_delta_scatter,
                "counts_window": rs.counts_window,
                "sparse_counts": rs.sparse_counts,
                "svc_matrix_build": rs.svc_matrix_build,
                "binpack_fill_step": pl.binpack_fill_step,
                "unpack_bits": bp.unpack_bits,
                "frontier_advance_burst": rr.frontier_advance_burst,
                "match_index_commit": rr.match_index_commit,
                "replay_log_scan": rr.replay_log_scan,
                "global_diff": rc.global_diff,
                "diff_compact": rc.diff_compact,
                "task_count_flat": rc.task_count_flat,
                "global_diff_churn_burst": rc.global_diff_churn_burst,
                "grant_order": ga.grant_order_launch,
                "replica_slot_state": rc.replica_slot_state,
                "sharded_water_fill_step": mf.sharded_water_fill_step,
                "sharded_binpack_fill_step": mf.sharded_binpack_fill_step,
                "sharded_replay_tally": rr.sharded_replay_tally,
                "sharded_delta_scatter": rm.sharded_delta_scatter,
                "sharded_counts_pull": rm.sharded_counts_pull}
    by_path = {"waves+flagship": drive(
        "waves+flagship", wrappers,
        lambda: (phase_waves(seed), phase_flagship(seed, flag_p)))}
    by_path["binpack"] = drive(
        "binpack", wrappers,
        lambda: (phase_waves(seed, "binpack"), phase_binpack_flagship(seed)))
    phase_native_walk(seed)

    rec = Recorder()
    for name in ("static_mask", "flat_fill_step", "tree_fill_step",
                 "binpack_fill_step"):
        rec.wrap(pl, name, key=lambda a, name=name: (
            f"{name} {rec.config}" if rec.config else None))
    for name in ("resident_delta_scatter", "counts_window", "sparse_counts"):
        rec.wrap(rs, name)
    rec.wrap(rs, "svc_matrix_build",
             key=lambda a: "svc_matrix_build" + (" zeros" if a[0].numel()
                                                 == 0 else ""))
    steady_ref = {}
    by_path["steady"] = drive("steady", wrappers,
                              lambda: phase_steady(seed, rec, steady_ref))
    steady_rows = check_steady_placement(rec)
    results.update(check_resident_kernels(rec))
    replay_rec = {}
    by_path["replay"] = drive("replay", wrappers,
                              lambda: phase_replay(seed, replay_rec))
    results.update(check_replay_kernels(replay_rec))
    by_path["int32"] = drive("int32", wrappers, lambda: phase_int32(seed))
    reconcile_rec = {}
    by_path["global"] = drive("global", wrappers,
                              lambda: phase_global(seed, reconcile_rec))
    by_path["reconcile"] = drive(
        "reconcile", wrappers, lambda: phase_reconcile(seed, reconcile_rec))
    results.update(check_reconcile_kernels(reconcile_rec))
    alloc_rec = []
    by_path["alloc"] = drive("alloc", wrappers,
                             lambda: phase_alloc(seed, alloc_rec))
    if by_path["alloc"]["grant_order"] < ALLOC_NODES // 200:
        fail(f"[alloc] K19 launched {by_path['alloc']['grant_order']} times, "
             f"fewer than the {ALLOC_NODES // 200} startup chunks")
    results.update(check_alloc_kernels(alloc_rec))
    repl_rec = []
    by_path["replicated"] = drive("replicated", wrappers,
                                  lambda: phase_replicated(seed, repl_rec))
    if by_path["replicated"]["replica_slot_state"] < 2:
        fail(f"[replicated] K18 launched "
             f"{by_path['replicated']['replica_slot_state']} times, not once "
             "for each leader's startup census")
    results.update(check_replicated_kernels(repl_rec))
    mesh_rec = {}
    by_path["mesh"] = drive("mesh", wrappers,
                            lambda: phase_mesh(seed, mesh_rec))
    results.update(check_mesh_kernels(mesh_rec))
    mesh_res_rec = Recorder()
    mesh_res_rec.wrap(rm, "sharded_delta_scatter")
    mesh_res_rec.wrap(rm, "sharded_counts_pull", key=lambda a: (
        "sharded_counts_pull " + ("dense" if len(a) == 4 else "sparse")))
    mesh_res_rec.wrap(rm, "sharded_fill", key=lambda a: (
        "sharded_fill" if a[2] == 0 else None))
    mesh_res_rec.wrap(rm, "sharded_static_mask")
    by_path["mesh_resident"] = drive(
        "mesh_resident", wrappers,
        lambda: phase_mesh_resident(seed, mesh_res_rec, steady_ref))
    del steady_ref
    ticks = 4 * (STEADY_WAVES + 1)      # 2 configurations x async, sync
    if by_path["mesh_resident"]["sharded_static_mask"] != ticks:
        fail(f"[mesh_resident] K1 launched "
             f"{by_path['mesh_resident']['sharded_static_mask']} times, not "
             f"once in each of the {ticks} ticks")
    results.update(check_mesh_resident_kernels(mesh_res_rec))
    for name in ("sharded_water_fill_step", "sharded_static_mask"):
        results[name]["mesh_resident"] = results.pop(f"{name} mesh_resident")
    for key, row in steady_rows.items():
        name, where = key.split()
        results[name][where] = row
    for name in ("tree_fill_step", "binpack_fill_step"):
        results[name]["mesh"] = results.pop(f"{name} mesh")

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        per_path = {p: n[name] for p, n in by_path.items()}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(per_path.values()), launches_by_path=per_path,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r.get("library_ms"), graph_ms=r.get("graph_ms"),
            equal_to_plain=r["max_abs_err"] == 0,
            **{k: r[k] for k in ("sparse", "zeros", "turns_ms",
                                 "ms_quorum_on_card",
                                 "graph_ms_quorum_on_card", "host_ns",
                                 "library_host_ns", "host_ns_turns",
                                 "library_graph_ms", "mesh_resident",
                                 "steady", "node_heavy", "mesh",
                                 "launch", "per_shard", "loop_ms",
                                 "loop_host_ns")
               if k in r}))
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
