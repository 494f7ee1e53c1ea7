// K9 binpack_fill_step: one group's step of the placement scan under the
// binpack strategy (prefer the fullest feasible node), on one device.
//
// Replaces: swarmkit_tpu/ops/placement.py `_binpack_fill` (:285) with the
// `_schedule_core` step (:336-374): per-node capacity, a stable lexsort of
// the nodes by (penalty, -svc, -total, node index), the prefix sum of the
// sorted capacities against the quota q = min(n_tasks, sum(cap)), each
// node's clip(q - prefix_before, 0, cap), and the fold of totals / service
// counts / resources / ports.
//
// The body is binpack_select.cuh's, over one shard of N nodes
// (water_fill.cuh `OneShard`, under a type of this library's): the
// boundary node of the key order found by a cap-weighted radix select, 8
// bits of a packed key a pass, over one thread block cluster with the
// per-step node state in shared memory. See that header for the design,
// the bound and the int32 intermediates.
#include "binpack_select.cuh"

namespace {

// K9's node policy: OneShard under a type of this library's own, so the
// body's launch-limit cache (a function-local static, one object in the
// process for a type two libraries share) is K9's alone (flat_fill.cu).
struct BinpackShard : skt::wf::OneShard {};

}  // namespace

// int32 words of scratch a step over N nodes needs: the node arrays, used
// when a block's share does not fit in shared memory. -1 when that exceeds
// an int.
extern "C" int skt_binpack_fill_scratch_i32(int N) {
  const long long w = skt::bp::node_words(N > 1 ? N : 1);
  return w > INT_MAX ? -1 : (int)w;
}

// How a step over N nodes launches: out[3] = cluster size, dynamic shared
// memory, nodes in shared memory.
extern "C" int skt_binpack_fill_plan(int N, void* out) {
  return skt::bp::plan_ints<BinpackShard>(N > 1 ? N : 1, (int*)out);
}

extern "C" int skt_binpack_fill_step(
    const void* mask, const void* need_res, const void* n_tasks,
    const void* svc_idx, const void* max_replicas, const void* penalty,
    const void* has_ports, const void* group_ports, void* totals,
    void* svc_counts, void* avail, void* port_used, void* out, void* flags,
    void* scratch, int g, int N, int R, int PV, void* stream) {
  skt::GroupArgs a{(const uint8_t*)mask,         (const int32_t*)need_res,
                   (const int32_t*)n_tasks,      (const int32_t*)svc_idx,
                   (const int32_t*)max_replicas, (const uint8_t*)penalty,
                   (const uint8_t*)has_ports,    (const uint8_t*)group_ports};
  skt::NodeState s{(int32_t*)totals, (int32_t*)svc_counts, (int32_t*)avail,
                   (uint8_t*)port_used};
  BinpackShard nodes{{a, s, nullptr, (int32_t*)out, N}};
  skt::bp::Params pm{g, R, PV, (int32_t*)flags, (int32_t*)scratch};
  return skt::bp::launch_step(nodes, pm, N, (cudaStream_t)stream);
}
