// K2 flat_fill_step: one group's step of the placement scan when the problem
// has no spread levels (LMAX == 0).
//
// Replaces: swarmkit_tpu/ops/placement.py `_schedule_core` step (:336-374)
// with `_flat_water_fill` (:173): per-node capacity, a 31-step scalar bisect
// for the water level, the remainder by stable order of (total + counts,
// node index), and the fold of totals / service counts / resources / ports.
//
// Bound on this card: the step reads and writes a few int32 per node
// (about 60 bytes per node at R = 3, PV = 2), a few hundred KB at 10k nodes,
// which the memory moves in well under a microsecond. What bounds the
// kernel is latency: ~75 dependent block-wide reductions (31 bisect steps,
// up to ~45 remainder-threshold steps) in one block of 1024 threads.
//
// Design: groups depend on each other through the node state, so the host
// launches one step per group, in order, on one stream. One block runs every
// phase of the step with __syncthreads between phases, so no phase needs a
// second launch or a grid-wide barrier. The remainder ranking needs no sort:
// with key = sec * N + idx (distinct, int64), the `rem` smallest keys are
// those <= the rem-th smallest key, found by a bisection on counts.
//
// int32 intermediates and their bounds (capsum = the group's capacity sum,
// taken in 64 bits and refused from 2^31, so every bound below fits):
//   cap, cnt, base counts       <= min(cap, n_tasks) of one node
//   filled, placed, q, rem      <= capsum
//   lo, hi, mid, level          in [0, 2^30] (the bisection's range)
//   k = PENALTY_BASE + svc      the service's tasks already on the node
//                               plus 2^20, as in the reference
//   d = level - k               in [-k, 2^30]
//   sec = totals + cnt          the node's total after this step, as the
//                               fold leaves it (SEC_PAD off the boundary)
//   the remainder keys          int64 (sec * N + n)
#include "common.cuh"

namespace skt {

__global__ void __launch_bounds__(FILL_THREADS, 1)
flat_fill_kernel(GroupArgs a, NodeState s, int g, int N, int R, int PV,
                 int32_t* out, int32_t* flags, int32_t* cap_s,
                 int32_t* k_s) {
  __shared__ int32_t red32[32];
  __shared__ long long red64[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int32_t svc_row = a.svc_idx[g];
  const int32_t* svc = s.svc_counts + (int64_t)svc_row * N;

  // phase 1: capacities, primary keys, the capacity sum in 64 bits
  long long local = 0;
  for (int n = tid; n < N; n += nt) {
    const int32_t sv = svc[n];
    const int32_t cap = node_cap(a, s, g, n, N, R, PV, sv);
    cap_s[n] = cap;
    k_s[n] = (a.penalty[(int64_t)g * N + n] ? PENALTY_BASE : 0) + sv;
    local += cap;
  }
  const long long capsum64 = block_sum(local, red64);
  if (refuse_overflow(capsum64, flags, g, out + (int64_t)g * N, N)) return;
  const int32_t capsum = (int32_t)capsum64;  // < 2^31
  const int32_t ntasks = a.n_tasks[g];
  const int32_t q = ntasks < capsum ? ntasks : capsum;

  // phase 2: largest level with filled(level) <= q (the reference's scan)
  int32_t lo = 0, hi = 1 << POUR_BITS;
  for (int step = 0; step <= POUR_BITS; ++step) {
    const int32_t mid = lo + (hi - lo + 1) / 2;
    int32_t f = 0;
    for (int n = tid; n < N; n += nt) {
      const int32_t d = mid - k_s[n];
      const int32_t c = cap_s[n];
      f += d <= 0 ? 0 : (d < c ? d : c);
    }
    const int32_t filled = block_sum(f, red32);
    if (filled <= q) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int32_t level = lo;

  // phase 3: base counts, remainder, and the largest remainder key
  int32_t placed = 0;
  long long kmax = 0;
  for (int n = tid; n < N; n += nt) {
    const int32_t d = level - k_s[n];
    const int32_t c = cap_s[n];
    const int32_t cnt = d <= 0 ? 0 : (d < c ? d : c);
    out[(int64_t)g * N + n] = cnt;
    placed += cnt;
    const bool bnd = c > cnt && k_s[n] <= level && cnt == d;
    const int32_t sec = bnd ? s.totals[n] + cnt : SEC_PAD;
    const long long key = (long long)sec * N + n;
    kmax = key > kmax ? key : kmax;
  }
  const int32_t rem = q - block_sum(placed, red32);
  kmax = block_max(kmax, red64);

  // phase 4: the rem smallest keys over ALL nodes (jnp.argsort(sec) is a
  // rank among every node; non-boundary nodes carry sec = 1 << 30)
  long long klo = 0, khi = kmax;
  if (rem > 0) {
    while (klo < khi) {  // block-uniform: klo/khi come from reductions
      const long long mid = klo + (khi - klo) / 2;
      int32_t cnt = 0;
      for (int n = tid; n < N; n += nt) {
        const int32_t base = out[(int64_t)g * N + n];
        const int32_t d = level - k_s[n];
        const bool bnd = cap_s[n] > base && k_s[n] <= level && base == d;
        const int32_t sec = bnd ? s.totals[n] + base : SEC_PAD;
        cnt += ((long long)sec * N + n) <= mid;
      }
      if (block_sum(cnt, red32) >= rem) {
        khi = mid;
      } else {
        klo = mid + 1;
      }
    }
  }
  __syncthreads();

  // phase 5: final counts and the state fold
  for (int n = tid; n < N; n += nt) {
    int32_t c = out[(int64_t)g * N + n];
    if (rem > 0) {
      const int32_t d = level - k_s[n];
      const bool bnd = cap_s[n] > c && k_s[n] <= level && c == d;
      if (bnd && ((long long)(s.totals[n] + c) * N + n) <= klo) c += 1;
    }
    out[(int64_t)g * N + n] = c;
    fold_node(a, s, g, n, N, R, PV, svc_row, c);
  }
}

}  // namespace skt

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
  int32_t* sc = (int32_t*)scratch;
  skt::flat_fill_kernel<<<1, skt::FILL_THREADS, 0, (cudaStream_t)stream>>>(
      a, s, g, N, R, PV, (int32_t*)out, (int32_t*)flags, sc, sc + N);
  return (int)cudaGetLastError();
}
