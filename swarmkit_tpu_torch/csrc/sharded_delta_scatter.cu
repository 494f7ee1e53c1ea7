// K23 sharded_delta_scatter: the row deltas of a resident tick, set into a
// node-sharded carry (k shards of n nodes on one card) by global row index.
//
// Replaces: swarmkit_tpu/ops/resident.py `_resident_tick_impl`, its
// has-deltas branch (:84-92), as `_mesh_ticks` (:126-147) runs it on the
// carry sharded over the node axis: for each delta d with global row
// i = d_idx[d], shard s = i / n and local row j = i % n,
//   ready_s[j] = d_ready[d], node_val_s[j, :] = d_val[d, :], node_plat_s,
//   node_plugins_s, port_used_s, avail_res_s, total0_s alike,
//   svc_mat_s[:, j] = d_svc[:, d].
// D is a power-of-two bucket; the host pads the index list by repeating its
// first row WITH THAT ROW'S DATA, so two blocks may write the same row, and
// then they write the same bytes. Rows outside [0, k * n) are skipped; the
// host refuses them before the upload.
//
// Bound on this card: memory, and at the sizes a steady tick ships (a few
// to a few hundred rows of ~100 bytes) the launch itself. Each delta byte
// is read once and written once.
//
// Design: K5's, with one level of indirection: one block per delta row
// reads its shard's eight carry pointers from a device table int64[k, 8]
// (STATE_FIELDS order) that the caller keeps for the life of the carry, so
// one launch serves every shard and nothing is uploaded per call; its
// threads stride over the row's columns of each array.
#include <cstdint>
#include <cuda_runtime.h>

namespace skt {

struct ShardedDeltas {
  const int32_t* idx;    // [D] global rows
  const uint8_t* ready;  // [D]
  const int32_t* val;    // [D, K]
  const int32_t* plat;   // [D, 2]
  const uint8_t* plug;   // [D, PL]
  const uint8_t* port;   // [D, PV]
  const int32_t* avail;  // [D, R]
  const int32_t* total;  // [D]
  const int32_t* svc;    // [S, D]
};

template <typename T>
__device__ __forceinline__ void set_row(int64_t dst, const T* src, int j,
                                        int d, int w) {
  T* out = reinterpret_cast<T*>(dst);
  for (int c = threadIdx.x; c < w; c += blockDim.x)
    out[(int64_t)j * w + c] = src[(int64_t)d * w + c];
}

__global__ void sharded_delta_scatter_kernel(ShardedDeltas a,
                                             const int64_t* table, int D,
                                             int k, int n, int K, int PL,
                                             int PV, int R, int S) {
  const int d = blockIdx.x;
  const int i = a.idx[d];
  if (i < 0 || i >= k * n) return;
  const int s = i / n, j = i - s * n;
  const int64_t* p = table + (int64_t)s * 8;
  set_row<int32_t>(p[1], a.val, j, d, K);
  set_row<int32_t>(p[2], a.plat, j, d, 2);
  set_row<uint8_t>(p[3], a.plug, j, d, PL);
  set_row<uint8_t>(p[4], a.port, j, d, PV);
  set_row<int32_t>(p[5], a.avail, j, d, R);
  int32_t* svc = reinterpret_cast<int32_t*>(p[7]);
  for (int r = threadIdx.x; r < S; r += blockDim.x)
    svc[(int64_t)r * n + j] = a.svc[(int64_t)r * D + d];
  if (threadIdx.x == 0) {
    reinterpret_cast<uint8_t*>(p[0])[j] = a.ready[d];
    reinterpret_cast<int32_t*>(p[6])[j] = a.total[d];
  }
}

}  // namespace skt

extern "C" int skt_sharded_delta_scatter(
    const void* d_idx, const void* d_ready, const void* d_val,
    const void* d_plat, const void* d_plug, const void* d_port,
    const void* d_avail, const void* d_total, const void* d_svc,
    const void* table, int D, int k, int n, int K, int PL, int PV, int R,
    int S, void* stream) {
  skt::ShardedDeltas a{(const int32_t*)d_idx,  (const uint8_t*)d_ready,
                       (const int32_t*)d_val,  (const int32_t*)d_plat,
                       (const uint8_t*)d_plug, (const uint8_t*)d_port,
                       (const int32_t*)d_avail, (const int32_t*)d_total,
                       (const int32_t*)d_svc};
  if (D <= 0) return 0;
  skt::sharded_delta_scatter_kernel<<<D, 128, 0, (cudaStream_t)stream>>>(
      a, (const int64_t*)table, D, k, n, K, PL, PV, R, S);
  return (int)cudaGetLastError();
}
