// K21 sharded_binpack_fill_step: one group's binpack step of the placement
// scan over k node shards on one card (the one-shot mesh path).
//
// Replaces: the sharded form of swarmkit_tpu/ops/placement.py
// `_binpack_fill` (:285) with the `_schedule_core` step (:336-374), as
// swarmkit_tpu/parallel/mesh.py's fused step runs it with the node axis
// sharded (`_fused_step` :276, `sharded_schedule` :213,
// `sharded_cluster_step` :224), XLA gathering the keys for its sort.
//
// Bound on this card: the step reads and writes a few int32 per node
// (about 80 bytes at R = 2, PV = 4), ~11 MB at 131,072 nodes, 3 us of
// memory time. What bounds the kernel is latency: a chain of dependent
// cross-shard reductions, each a grid barrier.
//
// Design: K9's algorithm (csrc/binpack_fill.cu) with each block-wide
// reduction a cross-shard psum (mesh.cuh); no sort and no gather. One block
// a shard, launched cooperatively; a block computes and folds only its
// shard's nodes. In key order (penalty, -svc, -total, global node index)
// every node before one boundary node B is full, B takes q - (capacity
// before B), every node after B takes 0. B's key is found one component at
// a time, each by a lower-bound bisection on "capacity of the nodes whose
// earlier components equal B's and whose component is <= v", summed over
// every shard. The node-index component runs over global indices
// (shard * n + i), the reference's order on the padded node axis; phantom
// pad nodes have no capacity and take 0.
//
// int32 intermediates and their bounds (capsum = the group's capacity sum
// over all shards, taken in 64 bits and refused from 2^31, so every bound
// below fits):
//   cap                          <= min(cap, n_tasks) of one node
//   f, below, base, need, q      <= capsum
//   smax, tmax, -nsmin, -ntmin   service and total counts of nodes with
//                                capacity (state, as in the reference)
//   the key components and the bisection bounds: int64
#include <climits>

#include "mesh.cuh"

namespace skt {

// Component c of a shard node's binpack key (csrc/binpack_fill.cu
// BinpackKey, with the node index made global).
struct ShardBinpackKey {
  const uint8_t* pen;   // [n] the group's penalty row of the shard
  const int32_t* svc;   // [n] the group's service-count row of the shard
  const int32_t* tot;   // [n] the shard's totals
  long long smax, tmax, base;

  __device__ __forceinline__ long long get(int c, int i) const {
    switch (c) {
      case 0:
        return pen[i] ? 1 : 0;
      case 1:
        return smax - svc[i];
      case 2:
        return tmax - tot[i];
      default:
        return base + i;
    }
  }
};

__global__ void __launch_bounds__(FILL_THREADS, 1)
sharded_binpack_fill_kernel(GroupSide gs, const ShardRow* rows, int g, int n,
                            int R, int PV, int32_t* flags, int32_t* cap_sc,
                            long long* xch) {
  __shared__ long long red64[32];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x, k = gridDim.x;
  const long long base = (long long)b * n;
  const ShardRow row = rows[b];
  const GroupArgs a = shard_group_args(gs, row);
  const NodeState s = shard_state(row);
  Exchange x{xch, 0};
  int32_t* cap_s = cap_sc + base;
  const int32_t svc_row = a.svc_idx[g];
  const int32_t* svc = s.svc_counts + (int64_t)svc_row * n;
  int32_t* out = row.out + (int64_t)g * n;

  // phase 1: the shard's capacities; the capacity sum in 64 bits and the
  // key ranges of nodes with capacity, over all shards
  long long local = 0;
  int32_t smax = INT_MIN, nsmin = INT_MIN, tmax = INT_MIN, ntmin = INT_MIN;
  for (int i = tid; i < n; i += nt) {
    const int32_t sv = svc[i];
    const int32_t cap = node_cap(a, s, g, i, n, R, PV, sv);
    cap_s[i] = cap;
    local += cap;
    if (cap > 0) {
      const int32_t t = s.totals[i];
      smax = sv > smax ? sv : smax;
      nsmin = -sv > nsmin ? -sv : nsmin;
      tmax = t > tmax ? t : tmax;
      ntmin = -t > ntmin ? -t : ntmin;
    }
  }
  const long long capsum64 = grid_sum(local, red64, x, grid);
  const bool over = capsum64 >= I32_LIMIT;  // grid-uniform
  if (b == 0 && tid == 0) flags[g] = over ? 1 : 0;
  if (over) {
    for (int i = tid; i < n; i += nt) out[i] = 0;
    return;
  }
  const int32_t capsum = (int32_t)capsum64;  // < 2^31
  smax = (int32_t)grid_max(smax, red64, x, grid);
  nsmin = (int32_t)grid_max(nsmin, red64, x, grid);
  tmax = (int32_t)grid_max(tmax, red64, x, grid);
  ntmin = (int32_t)grid_max(ntmin, red64, x, grid);
  const int32_t ntasks = a.n_tasks[g];
  const int32_t q = ntasks < capsum ? ntasks : capsum;
  const ShardBinpackKey key{a.penalty + (int64_t)g * n, svc, s.totals,
                            (long long)smax, (long long)tmax, base};

  // phase 2: B's key, one component at a time (grid-uniform: every bound
  // comes from a cross-shard reduction); `below` is the capacity before B
  long long fixed[4] = {0, 0, 0, 0};
  int32_t below_b = 0;
  if (q > 0 && q < capsum) {
    const long long range[4] = {1, (long long)smax + nsmin,
                                (long long)tmax + ntmin, (long long)k * n - 1};
    for (int c = 0; c < 4; ++c) {
      const int32_t need = q - below_b;  // > 0 at every component
      long long lo = 0, hi = range[c];
      int32_t below = 0;                 // capacity with component < lo
      while (lo < hi) {
        const long long mid = lo + (hi - lo) / 2;
        int32_t f = 0;
        for (int i = tid; i < n; i += nt) {
          const int32_t cap = cap_s[i];
          if (cap == 0) continue;
          bool match = true;
          for (int j = 0; j < c && match; ++j)
            match = key.get(j, i) == fixed[j];
          if (match && key.get(c, i) <= mid) f += cap;
        }
        const int32_t fsum = (int32_t)grid_sum(f, red64, x, grid);
        if (fsum >= need) {
          hi = mid;
        } else {
          lo = mid + 1;
          below = fsum;
        }
      }
      fixed[c] = lo;
      below_b += below;
    }
  }

  // phase 3: the shard's counts in key order around B, and its fold
  for (int i = tid; i < n; i += nt) {
    const int32_t cap = cap_s[i];
    int32_t c = q >= capsum ? cap : 0;
    if (q > 0 && q < capsum) {
      int cmp = 0;
      for (int j = 0; j < 4 && cmp == 0; ++j) {
        const long long kv = key.get(j, i);
        cmp = kv < fixed[j] ? -1 : (kv > fixed[j] ? 1 : 0);
      }
      c = cmp < 0 ? cap : (cmp == 0 ? q - below_b : 0);
    }
    out[i] = c;
    fold_node(a, s, g, i, n, R, PV, svc_row, c);
  }
}

}  // namespace skt

extern "C" int skt_sharded_binpack_fill_max_shards() {
  return skt::max_coresident((const void*)skt::sharded_binpack_fill_kernel);
}

extern "C" int skt_sharded_binpack_fill_step(
    const void* need_res, const void* n_tasks, const void* svc_idx,
    const void* max_replicas, const void* has_ports, const void* group_ports,
    const void* rows, void* flags, void* cap_scratch, void* exchange, int g,
    int k, int n, int R, int PV, void* stream) {
  skt::GroupSide gs{(const int32_t*)need_res, (const int32_t*)n_tasks,
                    (const int32_t*)svc_idx,  (const int32_t*)max_replicas,
                    (const uint8_t*)has_ports, (const uint8_t*)group_ports};
  const skt::ShardRow* r = (const skt::ShardRow*)rows;
  int32_t* fl = (int32_t*)flags;
  int32_t* csc = (int32_t*)cap_scratch;
  long long* xch = (long long*)exchange;
  void* args[] = {&gs, &r, &g, &n, &R, &PV, &fl, &csc, &xch};
  return skt::launch_cooperative(
      (const void*)skt::sharded_binpack_fill_kernel, k, args,
      (cudaStream_t)stream);
}
