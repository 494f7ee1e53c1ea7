// K21 sharded_binpack_fill_step: one group's binpack step of the placement
// scan over k node shards on one card (the one-shot mesh path and the mesh
// resident tick).
//
// Replaces: the sharded form of swarmkit_tpu/ops/placement.py
// `_binpack_fill` (:285) with the `_schedule_core` step (:336-374), as
// swarmkit_tpu/parallel/mesh.py's fused step runs it with the node axis
// sharded (`_fused_step` :276, `sharded_schedule` :213,
// `sharded_cluster_step` :224), XLA gathering the keys for its sort.
//
// The body is binpack_select.cuh's (K9's too), over k shards (water_fill.cuh
// `Shards`, under a type of this library's: a node's arrays through its
// shard's row of the pointer table, mesh.cuh ShardRow). The shards are a
// memory layout on one card: the blocks of one thread block cluster share
// the global node range [0, k * n) in chunks, whatever k, and the key's
// index field is the global index shard * n + i (bits(k * n - 1) wide),
// the reference's order on the padded node axis. Phantom pad nodes (ready
// False) have no capacity: they never enter the select, take 0 and fold
// nothing. See that header for the design, the bound and the int32
// intermediates.
#include "binpack_select.cuh"

namespace {

// K21's node policy: Shards under a type of this library's own, so the
// body's launch-limit cache (a function-local static, one object in the
// process for a type two libraries share) is K21's alone (binpack_fill.cu).
struct BinpackShards : skt::wf::Shards {};

// The most shards a launch takes. The shards do not map to blocks, so the
// limit is not the card's co-residency: as K20's (sharded_water_fill.cu),
// it keeps the per-call pointer table (64 B a shard) to one small upload.
constexpr int MAX_SHARDS = 1024;

}  // namespace

// int32 words of scratch a step over k x n nodes needs: the node arrays,
// used when a block's share does not fit in shared memory. -1 past an int.
extern "C" int skt_sharded_binpack_fill_scratch_i32(int k, int n) {
  const long long np = (long long)k * n;
  const long long w = skt::bp::node_words(np > 1 ? np : 1);
  return w > INT_MAX ? -1 : (int)w;
}

extern "C" int skt_sharded_binpack_fill_max_shards() { return MAX_SHARDS; }

// How a step over k x n nodes launches: out[3] = cluster size, dynamic
// shared memory, nodes in shared memory.
extern "C" int skt_sharded_binpack_fill_plan(int k, int n, void* out) {
  const long long np = (long long)k * n;
  return skt::bp::plan_ints<BinpackShards>(np > 1 ? np : 1, (int*)out);
}

extern "C" int skt_sharded_binpack_fill_step(
    const void* need_res, const void* n_tasks, const void* svc_idx,
    const void* max_replicas, const void* has_ports, const void* group_ports,
    const void* rows, void* flags, void* node_scratch, int g, int k, int n,
    int R, int PV, void* stream) {
  if (k < 1 || k > MAX_SHARDS || n < 0) return (int)cudaErrorInvalidValue;
  skt::GroupSide gs{(const int32_t*)need_res, (const int32_t*)n_tasks,
                    (const int32_t*)svc_idx,  (const int32_t*)max_replicas,
                    (const uint8_t*)has_ports, (const uint8_t*)group_ports};
  BinpackShards nodes{{gs, (const skt::ShardRow*)rows, k, n}};
  skt::bp::Params pm{g, R, PV, (int32_t*)flags, (int32_t*)node_scratch};
  return skt::bp::launch_step(nodes, pm, (long long)k * n,
                              (cudaStream_t)stream);
}
