// K2 flat_fill_step: one group's step of the placement scan when the problem
// has no spread levels (LMAX == 0), on one device.
//
// Replaces: swarmkit_tpu/ops/placement.py `_schedule_core` step (:336-374)
// with `_flat_water_fill` (:173): per-node capacity, a 31-step scalar bisect
// for the water level, the remainder by stable order of (total + counts,
// node index), and the fold of totals / service counts / resources / ports.
//
// The body is water_fill.cuh's L = 0 path over one shard of N nodes
// (`OneShard`, under a type of this library's; no branch ranks) with one
// branch slot (NB = 1, the shared route): several bits of the water level
// and of the remainder key a pass, one thread block cluster, the per-step
// state in shared memory. The
// remainder keys only boundary nodes ((totals + c) * N + n); the
// reference's off-boundary secondary key (SEC_PAD = 2^30) ranks after
// every boundary node while totals + c stays below 2^30 (a node's task
// count), and is never given a task, so both take the same rem nodes. See
// that header for the design, the bound and the int32 intermediates.
#include "water_fill.cuh"

namespace {

// K2's node policy: water_fill.cuh's OneShard under a type of this
// library's own. The body's launch limits are a function-local cache of
// each instantiation, and such statics are one object in the process for a
// type that two libraries share: over OneShard itself, K2 would take K3's
// cache (tree_fill.cu), and the shared-memory attribute would be set on
// whichever kernel came first.
struct FlatShard : skt::wf::OneShard {};

long long words_for(int N) {
  const long long n = N > 1 ? N : 1;
  return skt::wf::node_words(n) + skt::wf::scratch_words(1, 0);
}

}  // namespace

// int32 words of scratch a step over N nodes needs: the node arrays (used
// when a block's share does not fit in shared memory), then the home of
// the one branch slot. -1 when that exceeds an int.
extern "C" int skt_flat_fill_scratch_i32(int N) {
  const long long w = words_for(N);
  return w > INT_MAX ? -1 : (int)w;
}

// How a step over N nodes launches: out[4] = cluster size, dynamic shared
// memory, nodes in shared memory, the shared route.
extern "C" int skt_flat_fill_plan(int N, void* out) {
  return skt::wf::plan_ints<FlatShard>(N > 1 ? N : 1, 1, (int*)out);
}

extern "C" int skt_flat_fill_step(
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
  FlatShard nodes{{a, s, nullptr, (int32_t*)out, N}};
  int32_t* sc = (int32_t*)scratch;
  skt::wf::Params pm{g,  R,  PV, 0, 1, (int32_t*)flags, sc,
                     sc + skt::wf::node_words(N > 1 ? N : 1), nullptr};
  return skt::wf::launch_step(nodes, pm, N, (cudaStream_t)stream);
}
