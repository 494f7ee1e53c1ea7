// Shared device helpers of the placement kernels (flat_fill.cu, tree_fill.cu,
// binpack_fill.cu).
//
// The sums of a group step are int32, as in the JAX reference (which runs
// without x64). Each is bounded by the group's capacity sum, the sum over
// its eligible nodes of min(cap, n_tasks), which a step first takes in 64
// bits: when it reaches 2^31 (where the reference's int32 sums wrap) the
// step sets the group's overflow flag, places nothing and folds nothing
// (`refuse_overflow`), and the host raises when it reads the flags.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace skt {

constexpr int32_t UNLIMITED = 1 << 30;     // ops/placement.py UNLIMITED
constexpr int32_t PENALTY_BASE = 1 << 20;  // scheduler/spread.py PENALTY_BASE
constexpr int POUR_BITS = 30;              // 31 bisect steps, hi = 1 << 30
constexpr int32_t SEC_PAD = 1 << 30;       // secondary key off the boundary
constexpr long long I32_LIMIT = 1LL << 31;  // capacity sums refused from here

// floor(a / b) for b > 0 (jnp's `//` on int32)
__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {
  int32_t q = a / b;
  if ((a % b != 0) && (a < 0)) q -= 1;
  return q;
}

// A block-wide sum. `red` is a __shared__ scratch of 32 slots; every
// thread of the block must call, and every thread gets the result. The
// leading barrier protects `red` from the previous call's readers.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    T r = lane < nw ? red[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) r += __shfl_down_sync(0xffffffffu, r, o);
    if (lane == 0) red[0] = r;
  }
  __syncthreads();
  return red[0];
}

// Exclusive prefix sum of one int per thread, in thread order; `sh` is a
// __shared__ scratch of 32 slots. Returns the thread's exclusive prefix and
// writes the block total to *total.
__device__ __forceinline__ int32_t block_excl_scan(int32_t v, int32_t* sh,
                                                   int32_t* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int32_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) sh[w] = x;
  __syncthreads();
  if (w == 0) {
    int32_t s = lane < nw ? sh[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int32_t y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) sh[lane] = s;
  }
  __syncthreads();
  *total = sh[nw - 1];
  return (w > 0 ? sh[w - 1] : 0) + x - v;
}

// The overflow rule of a group step, block-uniform (`capsum` comes from a
// block reduction): writes flags[g] (1 when the capacity sum reaches 2^31,
// else 0, so a flag never outlives its step) and, on overflow, zeroes the
// group's counts row. The caller returns at once when it answers true.
__device__ __forceinline__ bool refuse_overflow(long long capsum,
                                                int32_t* flags, int g,
                                                int32_t* out_row, int N) {
  const bool over = capsum >= I32_LIMIT;
  if (threadIdx.x == 0) flags[g] = over ? 1 : 0;
  if (over)
    for (int n = threadIdx.x; n < N; n += blockDim.x) out_row[n] = 0;
  return over;
}

// Group-side inputs of one step (read-only), indexed by the group g.
struct GroupArgs {
  const uint8_t* mask;          // [G, N] static eligibility
  const int32_t* need_res;      // [G, R]
  const int32_t* n_tasks;       // [G]
  const int32_t* svc_idx;       // [G]
  const int32_t* max_replicas;  // [G]
  const uint8_t* penalty;       // [G, N]
  const uint8_t* has_ports;     // [G]
  const uint8_t* group_ports;   // [G, PV]
};

// Node-side carry, folded in place at the end of each step.
struct NodeState {
  int32_t* totals;      // [N]
  int32_t* svc_counts;  // [S, N]
  int32_t* avail;       // [N, R]
  uint8_t* port_used;   // [N, PV]
};

// The group's capacity on node n before the fill:
//   min(where(eligible, clip(min(cap_res, cap_mr, cap_port), 0, UNLIMITED),
//       0), n_tasks)
// (ops/placement.py _schedule_core step + the fill's eligibility clip).
__device__ __forceinline__ int32_t node_cap(const GroupArgs& a,
                                            const NodeState& s, int g, int n,
                                            int N, int R, int PV,
                                            int32_t svc) {
  if (!a.mask[(int64_t)g * N + n]) return 0;
  int32_t cap = UNLIMITED;
  for (int r = 0; r < R; ++r) {
    const int32_t need = a.need_res[(int64_t)g * R + r];
    if (need > 0) {
      const int32_t c = floordiv(s.avail[(int64_t)n * R + r], need);
      cap = c < cap ? c : cap;
    }
  }
  const int32_t mr = a.max_replicas[g];
  if (mr > 0) {
    const int32_t c = mr - svc;
    cap = c < cap ? c : cap;
  }
  if (a.has_ports[g]) {
    bool conflict = false;
    for (int p = 0; p < PV; ++p)
      conflict |= a.group_ports[(int64_t)g * PV + p] &&
                  s.port_used[(int64_t)n * PV + p];
    const int32_t c = conflict ? 0 : 1;
    cap = c < cap ? c : cap;
  }
  cap = cap < 0 ? 0 : (cap > UNLIMITED ? UNLIMITED : cap);
  const int32_t nt = a.n_tasks[g];
  return cap < nt ? cap : nt;
}

// The state fold after a group's fill (ops/placement.py:364-373):
// totals += c, svc_counts[svc] += c, avail -= c * need, port_used |= ports
// where c > 0. c * need <= avail for every resource the group needs (c is
// at most avail / need there), and 0 for the others.
__device__ __forceinline__ void fold_node(const GroupArgs& a,
                                          const NodeState& s, int g, int n,
                                          int N, int R, int PV, int32_t svc_row,
                                          int32_t c) {
  s.totals[n] += c;
  s.svc_counts[(int64_t)svc_row * N + n] += c;
  for (int r = 0; r < R; ++r)
    s.avail[(int64_t)n * R + r] -= c * a.need_res[(int64_t)g * R + r];
  if (c > 0)
    for (int p = 0; p < PV; ++p)
      if (a.group_ports[(int64_t)g * PV + p])
        s.port_used[(int64_t)n * PV + p] = 1;
}

}  // namespace skt
