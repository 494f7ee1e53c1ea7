// K9 binpack_fill_step: one group's step of the placement scan under the
// binpack strategy (prefer the fullest feasible node).
//
// Replaces: swarmkit_tpu/ops/placement.py `_binpack_fill` (:285) with the
// `_schedule_core` step (:336-374): per-node capacity, a stable lexsort of
// the nodes by (penalty, -svc, -total, node index), the prefix sum of the
// sorted capacities against the quota q = min(n_tasks, sum(cap)), each
// node's clip(q - prefix_before, 0, cap), and the fold of totals / service
// counts / resources / ports.
//
// Bound on this card: the step reads and writes a few int32 per node (about
// 60 bytes per node at R = 3, PV = 2), which the memory moves in well under
// a microsecond at 10k-131k nodes. What bounds the kernel is latency: a
// chain of dependent block-wide reductions in one block of 1024 threads.
//
// Design: no sort. The key is distinct (the node index breaks ties), so in
// key order every node before one boundary node B is full, B takes
// q - (capacity before B), and every node after B takes 0; nodes with no
// capacity take 0 wherever they sit. B is the node of smallest key whose
// inclusive capacity prefix reaches q. The kernel finds B one key component
// at a time, each by a lower-bound bisection on "sum of cap over the nodes
// whose earlier components equal B's and whose component is <= v" (one
// block-wide reduction per step), as K2 finds its remainder threshold:
//   penalty                  1 step;
//   -svc (as smax - svc)     ceil(log2(svc range + 1)) steps, at most 31;
//   -total (as tmax - total) ceil(log2(total range + 1)) steps, at most 31;
//   node index               ceil(log2 N) steps, 17 at 131,072 nodes;
// where the ranges are those of the group's nodes with capacity (phase 1),
// so a steady grid group takes ~25 steps, not 80. The sum below the
// bisection's answer falls out of its last step that moved `lo`, so each
// component costs its steps and nothing more. When q is 0 or the whole
// capacity, no search runs. Groups depend on each other through the node
// state, so the host launches one step per group, in order, on one stream.
//
// int32 intermediates and their bounds (capsum = the group's capacity sum,
// taken in 64 bits and refused from 2^31, so every bound below fits):
//   cap                          <= min(cap, n_tasks) of one node
//   f, below, base, need, q      <= capsum
//   smax, tmax, -nsmin, -ntmin   service and total counts of nodes with
//                                capacity (state, as in the reference)
//   the key components and the bisection bounds: int64
#include <climits>

#include "common.cuh"

namespace skt {

// Component c of node n's binpack key; every component ascends in the
// binpack order. Nodes without capacity may fall outside [0, range]: the
// int64 arithmetic keeps their components exact, and they take 0 anyway.
struct BinpackKey {
  const uint8_t* pen;   // [N] the group's penalty row
  const int32_t* svc;   // [N] the group's service-count row
  const int32_t* tot;   // [N] totals
  long long smax, tmax;

  __device__ __forceinline__ long long get(int c, int n) const {
    switch (c) {
      case 0:
        return pen[n] ? 1 : 0;
      case 1:
        return smax - svc[n];
      case 2:
        return tmax - tot[n];
      default:
        return n;
    }
  }
};

__global__ void __launch_bounds__(FILL_THREADS, 1)
binpack_fill_kernel(GroupArgs a, NodeState s, int g, int N, int R, int PV,
                    int32_t* out, int32_t* flags, int32_t* cap_s) {
  __shared__ int32_t red32[32];
  __shared__ long long red64[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int32_t svc_row = a.svc_idx[g];
  const int32_t* svc = s.svc_counts + (int64_t)svc_row * N;

  // phase 1: capacities, their sum in 64 bits, the key ranges of nodes
  // with capacity
  long long local = 0;
  int32_t smax = INT_MIN, nsmin = INT_MIN, tmax = INT_MIN, ntmin = INT_MIN;
  for (int n = tid; n < N; n += nt) {
    const int32_t sv = svc[n];
    const int32_t cap = node_cap(a, s, g, n, N, R, PV, sv);
    cap_s[n] = cap;
    local += cap;
    if (cap > 0) {
      const int32_t t = s.totals[n];
      smax = sv > smax ? sv : smax;
      nsmin = -sv > nsmin ? -sv : nsmin;
      tmax = t > tmax ? t : tmax;
      ntmin = -t > ntmin ? -t : ntmin;
    }
  }
  const long long capsum64 = block_sum(local, red64);
  if (refuse_overflow(capsum64, flags, g, out + (int64_t)g * N, N)) return;
  const int32_t capsum = (int32_t)capsum64;  // < 2^31
  smax = block_max(smax, red32);
  nsmin = block_max(nsmin, red32);
  tmax = block_max(tmax, red32);
  ntmin = block_max(ntmin, red32);
  const int32_t ntasks = a.n_tasks[g];
  const int32_t q = ntasks < capsum ? ntasks : capsum;
  const BinpackKey key{a.penalty + (int64_t)g * N, svc, s.totals,
                       (long long)smax, (long long)tmax};

  // phase 2: B's key, one component at a time (block-uniform: every bound
  // comes from a reduction); `base` is the capacity before B
  long long fixed[4] = {0, 0, 0, 0};
  int32_t base = 0;
  if (q > 0 && q < capsum) {
    const long long range[4] = {1, (long long)smax + nsmin,
                                (long long)tmax + ntmin, N - 1};
    for (int c = 0; c < 4; ++c) {
      const int32_t need = q - base;  // > 0 at every component
      long long lo = 0, hi = range[c];
      int32_t below = 0;              // sum of cap with component < lo
      while (lo < hi) {
        const long long mid = lo + (hi - lo) / 2;
        int32_t f = 0;
        for (int n = tid; n < N; n += nt) {
          const int32_t cap = cap_s[n];
          if (cap == 0) continue;
          bool match = true;
          for (int j = 0; j < c && match; ++j)
            match = key.get(j, n) == fixed[j];
          if (match && key.get(c, n) <= mid) f += cap;
        }
        f = block_sum(f, red32);
        if (f >= need) {
          hi = mid;
        } else {
          lo = mid + 1;
          below = f;
        }
      }
      fixed[c] = lo;
      base += below;
    }
  }
  __syncthreads();

  // phase 3: counts in key order around B (fixed[3] is B's index), fold
  for (int n = tid; n < N; n += nt) {
    const int32_t cap = cap_s[n];
    int32_t c = q >= capsum ? cap : 0;
    if (q > 0 && q < capsum) {
      int cmp = 0;
      for (int j = 0; j < 4 && cmp == 0; ++j) {
        const long long k = key.get(j, n);
        cmp = k < fixed[j] ? -1 : (k > fixed[j] ? 1 : 0);
      }
      c = cmp < 0 ? cap : (cmp == 0 ? q - base : 0);
    }
    out[(int64_t)g * N + n] = c;
    fold_node(a, s, g, n, N, R, PV, svc_row, c);
  }
}

}  // namespace skt

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
  skt::binpack_fill_kernel<<<1, skt::FILL_THREADS, 0, (cudaStream_t)stream>>>(
      a, s, g, N, R, PV, (int32_t*)out, (int32_t*)flags, (int32_t*)scratch);
  return (int)cudaGetLastError();
}
