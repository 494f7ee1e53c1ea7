// K20 sharded_water_fill_step: one group's spread step of the placement
// scan over k node shards on one card (the one-shot mesh path and the mesh
// resident tick).
//
// Replaces: the sharded forms of swarmkit_tpu/ops/placement.py
// `_flat_water_fill` (:173), `_tree_water_fill` (:209) and
// `_segmented_pour` (:132) inside the `_schedule_core` step (:336-374), as
// swarmkit_tpu/parallel/mesh.py's fused step (`_fused_step` :276,
// `sharded_schedule` :213, `sharded_cluster_step` :224) runs them with the
// node axis sharded and XLA inserting the cross-shard psums.
//
// The body is water_fill.cuh's, over k shards (`Shards`: a node's arrays
// through its shard's row of the pointer table, mesh.cuh ShardRow). The
// shards are a memory layout on one card: the blocks of one thread block
// cluster share the global node range [0, k * n) in chunks, whatever k. Branch ids are global (< k * n); NB is one past the
// largest (1 when L = 0, the flat fill), checked by the caller. Phantom
// pad nodes (ready False, spread rank 0, no capacity) join branch 0 and
// change no pour; the padded count keeps the remainder keys distinct.
#include "water_fill.cuh"

namespace skt {
// The most shards a launch takes. The shards no longer map to blocks, so
// the limit is not the card's co-residency: it keeps the per-call pointer
// table (64 B a shard) to one small upload.
constexpr int SWF_MAX_SHARDS = 1024;
}  // namespace skt

// int32 words of scratch: which 0, the home and slot state for NB branch
// slots and L levels; 1, the node arrays of Np nodes. -1 past an int.
extern "C" int skt_sharded_water_fill_scratch(int which, int Np, int NB,
                                              int L) {
  const long long w = which == 0
                          ? skt::wf::scratch_words(NB > 1 ? NB : 1, L)
                          : skt::wf::node_words(Np > 1 ? Np : 1);
  return w > INT_MAX ? -1 : (int)w;
}

extern "C" int skt_sharded_water_fill_max_shards() {
  return skt::SWF_MAX_SHARDS;
}

// How a step over k x n nodes with NB branch slots launches: out[4] =
// cluster size, dynamic shared memory, nodes in shared memory, the shared
// route.
extern "C" int skt_sharded_water_fill_plan(int k, int n, int NB, void* out) {
  return skt::wf::plan_ints<skt::wf::Shards>((long long)k * n, NB,
                                             (int*)out);
}

extern "C" int skt_sharded_water_fill_step(
    const void* need_res, const void* n_tasks, const void* svc_idx,
    const void* max_replicas, const void* has_ports, const void* group_ports,
    const void* rows, void* flags, void* node_scratch, void* branch_scratch,
    void* branch_scratch64, void* exchange, int g, int k, int n, int R,
    int PV, int L, int NB, void* stream) {
  (void)exchange;  // the cross-block sums go through the cluster
  if (k < 1 || k > skt::SWF_MAX_SHARDS || NB < 1)
    return (int)cudaErrorInvalidValue;
  skt::GroupSide gs{(const int32_t*)need_res, (const int32_t*)n_tasks,
                    (const int32_t*)svc_idx,  (const int32_t*)max_replicas,
                    (const uint8_t*)has_ports, (const uint8_t*)group_ports};
  skt::wf::Shards nodes{gs, (const skt::ShardRow*)rows, k, n};
  skt::wf::Params pm{g,  R,  PV, L, NB, (int32_t*)flags,
                     (int32_t*)node_scratch, (int32_t*)branch_scratch,
                     (long long*)branch_scratch64};
  return skt::wf::launch_step(nodes, pm, (long long)k * n,
                              (cudaStream_t)stream);
}
