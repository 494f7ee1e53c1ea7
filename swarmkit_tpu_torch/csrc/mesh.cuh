// The shard layout of the sharded placement kernels (K20
// sharded_water_fill.cu, K21 sharded_binpack_fill.cu).
//
// A mesh on one card is k node shards, each its own set of tensors. A
// kernel reaches shard b's node arrays through row b of a per-shard
// pointer table (water_fill.cuh `Shards`); the group-side tables are one
// replicated copy. The cross-shard sums (the reference's `lax.psum` over
// the node axis, which XLA inserts) are the kernels' own cross-block sums
// over the global node range: integer sums, exact in any order.
#pragma once

#include "common.cuh"

namespace skt {

// One shard's node-axis arrays: a row of the pointer table (8 pointers, in
// this order; parallel/fill.py `_shard_rows`). n is the shard's node count.
struct ShardRow {
  const uint8_t* mask;         // [G, n] static eligibility
  const uint8_t* penalty;      // [G, n]
  const int32_t* spread_rank;  // [G, L, n] global branch ids (< N padded)
  int32_t* totals;             // [n]
  int32_t* svc_counts;         // [S, n]
  int32_t* avail;              // [n, R]
  uint8_t* port_used;          // [n, PV]
  int32_t* out;                // [G, n] counts
};

// The group-side tables, replicated: one copy on the card.
struct GroupSide {
  const int32_t* need_res;      // [G, R]
  const int32_t* n_tasks;       // [G]
  const int32_t* svc_idx;       // [G]
  const int32_t* max_replicas;  // [G]
  const uint8_t* has_ports;     // [G]
  const uint8_t* group_ports;   // [G, PV]
};

// A shard's view in the one-device kernels' terms, so that node_cap and
// fold_node (common.cuh) apply unchanged with N = n.
__device__ __forceinline__ GroupArgs shard_group_args(const GroupSide& gs,
                                                      const ShardRow& r) {
  return GroupArgs{r.mask,      gs.need_res,  gs.n_tasks,    gs.svc_idx,
                   gs.max_replicas, r.penalty, gs.has_ports, gs.group_ports};
}

__device__ __forceinline__ NodeState shard_state(const ShardRow& r) {
  return NodeState{r.totals, r.svc_counts, r.avail, r.port_used};
}

}  // namespace skt
