// K5 resident_delta_scatter: the row deltas of a resident tick, set into the
// node state that stays on the card between ticks.
//
// Replaces: swarmkit_tpu/ops/resident.py `_resident_tick_impl`, its
// has-deltas branch (:84-92): for each delta d with node row n = d_idx[d],
//   ready[n] = d_ready[d], node_val[n, :] = d_val[d, :], node_plat[n, :],
//   node_plugins[n, :], port_used[n, :], avail_res[n, :], total0[n] alike,
//   svc_mat[:, n] = d_svc[:, d].
// D is a power-of-two bucket; the host pads the index list by repeating its
// first row WITH THAT ROW'S DATA, so two blocks may write the same row, and
// then they write the same bytes: the duplicates are harmless.
//
// Bound on this card: memory, and at the sizes a steady tick ships (a few
// to a few hundred rows of ~100 bytes) the launch itself. Each delta byte is
// read once and written once.
//
// Design: one block per delta row; its threads stride over the row's
// columns of each array (contiguous in the [N, W] arrays; the service
// column is strided by N in svc_mat, one element per service row).
#include <cstdint>
#include <cuda_runtime.h>

namespace skt {

struct Deltas {
  const int32_t* idx;    // [D]
  const uint8_t* ready;  // [D]
  const int32_t* val;    // [D, K]
  const int32_t* plat;   // [D, 2]
  const uint8_t* plug;   // [D, PL]
  const uint8_t* port;   // [D, PV]
  const int32_t* avail;  // [D, R]
  const int32_t* total;  // [D]
  const int32_t* svc;    // [S, D]
};

struct State {
  uint8_t* ready;         // [N]
  int32_t* node_val;      // [N, K]
  int32_t* node_plat;     // [N, 2]
  uint8_t* node_plugins;  // [N, PL]
  uint8_t* port_used;     // [N, PV]
  int32_t* avail_res;     // [N, R]
  int32_t* total0;        // [N]
  int32_t* svc_mat;       // [S, N]
};

template <typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* src, int n, int d,
                                         int w) {
  for (int j = threadIdx.x; j < w; j += blockDim.x)
    dst[(int64_t)n * w + j] = src[(int64_t)d * w + j];
}

__global__ void delta_scatter_kernel(Deltas a, State s, int D, int N, int K,
                                     int PL, int PV, int R, int S) {
  const int d = blockIdx.x;
  const int n = a.idx[d];
  if (n < 0 || n >= N) return;  // the host checks; never write outside
  copy_row(s.node_val, a.val, n, d, K);
  copy_row(s.node_plat, a.plat, n, d, 2);
  copy_row(s.node_plugins, a.plug, n, d, PL);
  copy_row(s.port_used, a.port, n, d, PV);
  copy_row(s.avail_res, a.avail, n, d, R);
  for (int r = threadIdx.x; r < S; r += blockDim.x)
    s.svc_mat[(int64_t)r * N + n] = a.svc[(int64_t)r * D + d];
  if (threadIdx.x == 0) {
    s.ready[n] = a.ready[d];
    s.total0[n] = a.total[d];
  }
}

}  // namespace skt

extern "C" int skt_resident_delta_scatter(
    const void* d_idx, const void* d_ready, const void* d_val,
    const void* d_plat, const void* d_plug, const void* d_port,
    const void* d_avail, const void* d_total, const void* d_svc, void* ready,
    void* node_val, void* node_plat, void* node_plugins, void* port_used,
    void* avail_res, void* total0, void* svc_mat, int D, int N, int K, int PL,
    int PV, int R, int S, void* stream) {
  skt::Deltas a{(const int32_t*)d_idx,  (const uint8_t*)d_ready,
                (const int32_t*)d_val,  (const int32_t*)d_plat,
                (const uint8_t*)d_plug, (const uint8_t*)d_port,
                (const int32_t*)d_avail, (const int32_t*)d_total,
                (const int32_t*)d_svc};
  skt::State s{(uint8_t*)ready,     (int32_t*)node_val, (int32_t*)node_plat,
               (uint8_t*)node_plugins, (uint8_t*)port_used,
               (int32_t*)avail_res, (int32_t*)total0, (int32_t*)svc_mat};
  skt::delta_scatter_kernel<<<D, 128, 0, (cudaStream_t)stream>>>(
      a, s, D, N, K, PL, PV, R, S);
  return (int)cudaGetLastError();
}
