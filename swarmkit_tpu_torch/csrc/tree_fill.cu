// K3 tree_fill_step: one group's step of the placement scan when the problem
// has spread levels (LMAX > 0), on one device.
//
// Replaces: swarmkit_tpu/ops/placement.py `_schedule_core` step (:336-374)
// with `_tree_water_fill` (:209) and `_segmented_pour` (:132).
//
// The body is water_fill.cuh's, over one shard of N nodes (`OneShard`):
// several bits of each water level and remainder key a pass, one chain of
// cluster barriers whatever LMAX, the per-step state in shared memory, the
// branch slots bounded on the device by one past the group's largest
// branch id (found in the step's first pass, so the wrapper keeps its
// signature). See that header for the design, the bound and the int32
// intermediates.
#include "water_fill.cuh"

namespace {

long long words_for(int N, int L) {
  const long long n = N > 1 ? N : 1;
  const long long small = n < skt::wf::SLOT_SMEM ? n : skt::wf::SLOT_SMEM;
  const long long a = skt::wf::scratch_words(small, L);
  const long long b = skt::wf::scratch_words(n, L);
  return skt::wf::node_words(n) + (a > b ? a : b);
}

}  // namespace

// int32 words of scratch a step over N nodes and L levels needs: the node
// arrays, then the home and slot state for any branch bound up to N (the
// step finds the bound on the device). -1 when that exceeds an int.
extern "C" int skt_tree_fill_scratch_i32(int N, int L) {
  const long long w = words_for(N, L);
  return w > INT_MAX ? -1 : (int)w;
}

// How a step over N nodes whose group has NB branch slots launches:
// out[4] = cluster size, dynamic shared memory, nodes in shared memory,
// the shared route.
extern "C" int skt_tree_fill_plan(int N, int NB, void* out) {
  return skt::wf::plan_ints<skt::wf::OneShard>(N, NB, (int*)out);
}

extern "C" int skt_tree_fill_step(
    const void* mask, const void* need_res, const void* n_tasks,
    const void* svc_idx, const void* max_replicas, const void* penalty,
    const void* has_ports, const void* group_ports, const void* spread_rank,
    void* totals, void* svc_counts, void* avail, void* port_used, void* out,
    void* flags, void* scratch, void* scratch64, int g, int N, int R, int PV,
    int L, void* stream) {
  skt::GroupArgs a{(const uint8_t*)mask,         (const int32_t*)need_res,
                   (const int32_t*)n_tasks,      (const int32_t*)svc_idx,
                   (const int32_t*)max_replicas, (const uint8_t*)penalty,
                   (const uint8_t*)has_ports,    (const uint8_t*)group_ports};
  skt::NodeState s{(int32_t*)totals, (int32_t*)svc_counts, (int32_t*)avail,
                   (uint8_t*)port_used};
  skt::wf::OneShard nodes{a, s, (const int32_t*)spread_rank, (int32_t*)out,
                          N};
  int32_t* sc = (int32_t*)scratch;
  skt::wf::Params pm{g,  R,  PV, L, 0, (int32_t*)flags, sc,
                     sc + skt::wf::node_words(N > 1 ? N : 1),
                     (long long*)scratch64};
  return skt::wf::launch_step(nodes, pm, N, (cudaStream_t)stream);
}
