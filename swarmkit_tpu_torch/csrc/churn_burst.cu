// K17 churn_burst: B rounds of the O(churn) incremental global diff in one
// launch, on the device-resident task table and count carry.
//
// Replaces: swarmkit_tpu/ops/reconcile.py `global_diff_churn_burst` (:136),
// the `lax.scan` of `_churn_step` (:113), and `global_diff_churn` (:167),
// one round with its pairs. Per round, over U update triples (r, c, v),
// slots unique within the round:
//   old = tn[r, c];  tn[r, c] = v
//   cnt[r * N + max(old, 0)] -= (old >= 0);  cnt[r * N + max(v, 0)] += (v >= 0)
//   for the 2U pairs i (i < U: (r, max(old, 0)), else (r, max(v, 0))):
//     valid = (old or v) >= 0
//     e = eligible[r, min(n, N - 1)];  k = cnt[min(r * N + n, S * N - 1)]
//     code = (valid & e & k == 0) | (valid & !e & k > 0) << 1 | valid << 2
// An add past S * N is dropped (the reference's scatter drops it; a value
// of N lands in the count of (r + 1, 0)). The host refuses S * N >= 2^31
// and r * N + v >= 2^31, where the reference's int32 index wraps. tn and
// cnt are the wrapper's copies: the inputs stay as they were.
//
// Bound on this card: the function's bytes. It returns new carries, so it
// must read and write the table and the counts once (4 * S * (T + N) each
// way: 83 MB at 200 x 50,000, T = 2,000, about 25 us at 3.35 TB/s; the
// wrapper's two copies move them), plus 12 B U bytes of triples and 2 B U
// codes; the rounds themselves touch only O(B U) cells.
//
// Design: the simple one. One block of 1024 threads loops over the B
// rounds; in a round the threads stride over U (gather old into a [U]
// scratch, set new, atomicAdd -1 and +1), meet at a barrier, stride over
// the 2U pairs (gather eligibility and count, write the codes, and in the
// one-round form the pairs), and meet again. The barrier makes each
// round's adds visible to the next round's gathers without a second
// launch. One SM is far below the card: the rounds run at its latency, not
// the card's rate.
#include <cstdint>
#include <cuda_runtime.h>

namespace skt {

constexpr int CB_THREADS = 1024;

__global__ void __launch_bounds__(CB_THREADS, 1)
churn_burst_kernel(const uint8_t* __restrict__ eligible, int32_t* tn,
                   int32_t* cnt, const int32_t* __restrict__ rows_b,
                   const int32_t* __restrict__ cols_b,
                   const int32_t* __restrict__ vals_b, int32_t* old,
                   uint8_t* codes_b, int32_t* pairs, int S, int N, int T,
                   int U, int B) {
  const int64_t SN = (int64_t)S * N;
  for (int b = 0; b < B; ++b) {
    const int32_t* rows = rows_b + (int64_t)b * U;
    const int32_t* cols = cols_b + (int64_t)b * U;
    const int32_t* vals = vals_b + (int64_t)b * U;
    for (int u = threadIdx.x; u < U; u += blockDim.x) {
      const int64_t r = rows[u];
      const int32_t v = vals[u];
      int32_t* slot = tn + r * T + cols[u];
      const int32_t o = *slot;
      old[u] = o;
      *slot = v;
      if (o >= 0 && r * N + o < SN) atomicAdd(cnt + r * N + o, -1);
      if (v >= 0 && r * N + v < SN) atomicAdd(cnt + r * N + v, 1);
    }
    __syncthreads();
    uint8_t* codes = codes_b + (int64_t)b * 2 * U;
    for (int i = threadIdx.x; i < 2 * U; i += blockDim.x) {
      const int u = i < U ? i : i - U;
      const int64_t r = rows[u];
      const int32_t x = i < U ? old[u] : vals[u];
      const int32_t n = x > 0 ? x : 0;
      const bool valid = x >= 0;
      const bool e = eligible[r * N + (n < N ? n : N - 1)];
      const int64_t f = r * N + n;
      // the adds happened in L2: read the count from there, past L1
      const int32_t k = __ldcg(cnt + (f < SN ? f : SN - 1));
      const bool create = valid && e && k == 0;
      const bool shutdown = valid && !e && k > 0;
      codes[i] = (uint8_t)(create | (shutdown << 1) | (valid << 2));
      if (pairs != nullptr) {
        pairs[2 * i] = (int32_t)r;
        pairs[2 * i + 1] = n;
      }
    }
    __syncthreads();
  }
}

}  // namespace skt

// tn int32[S, T] and cnt int32[S * N] are updated in place (the wrapper
// passes copies); triples int32[B, U]; old: int32[U] scratch; codes
// uint8[B, 2U]; pairs int32[2U, 2] or null (B == 1 only).
extern "C" int skt_churn_burst(const void* eligible, void* tn, void* cnt,
                               const void* rows_b, const void* cols_b,
                               const void* vals_b, void* old, void* codes,
                               void* pairs, int S, int N, int T, int U,
                               int B, void* stream) {
  skt::churn_burst_kernel<<<1, skt::CB_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)eligible, (int32_t*)tn, (int32_t*)cnt,
      (const int32_t*)rows_b, (const int32_t*)cols_b, (const int32_t*)vals_b,
      (int32_t*)old, (uint8_t*)codes, (int32_t*)pairs, S, N, T, U, B);
  return (int)cudaGetLastError();
}
