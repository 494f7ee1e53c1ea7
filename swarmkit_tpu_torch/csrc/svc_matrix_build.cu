// K8 svc_matrix_build: the resident [S, N] per-service count matrix, made
// on the card from its nonzero cells instead of shipped dense.
//
// Replaces: the cold-upload svc-matrix branches of swarmkit_tpu/ops/
// resident.py `_upload_full` (:351-380) and the single-device form of
// `_sharded_zeros` (:150-158):
//   out = zeros(S * N); out[idx[i]] += val[i] for i < nnz
// (a FLAT scatter-add, viewed as [S, N] by the caller). nnz == 0 is the
// all-zero branch. The host sends unique indices; the add is atomic all the
// same, so a repeated index sums as the reference's `.at[].add` does.
//
// Bound on this card: memory. It writes 4 bytes per cell and reads 8 per
// pair; the scattered adds touch one cell each.
//
// Design: a grid-stride zero fill, then one thread per pair.
#include <cstdint>
#include <cuda_runtime.h>

namespace skt {

__global__ void zero_kernel(int32_t* out, int64_t cells) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < cells;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = 0;
}

__global__ void scatter_add_kernel(const int32_t* idx, const int32_t* val,
                                   int32_t* out, int64_t cells, int nnz) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nnz) return;
  const int32_t c = idx[i];
  if (c >= 0 && c < cells) atomicAdd(out + c, val[i]);
}

}  // namespace skt

extern "C" int skt_svc_matrix_build(const void* idx, const void* val,
                                    void* out, long long cells, int nnz,
                                    void* stream) {
  const int threads = 256;
  cudaStream_t st = (cudaStream_t)stream;
  int64_t blocks = (cells + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;  // grid-stride covers the rest
  if (blocks > 0) {
    skt::zero_kernel<<<(unsigned)blocks, threads, 0, st>>>((int32_t*)out,
                                                          cells);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (nnz > 0)
    skt::scatter_add_kernel<<<(unsigned)((nnz + threads - 1) / threads),
                              threads, 0, st>>>(
        (const int32_t*)idx, (const int32_t*)val, (int32_t*)out, cells, nnz);
  return (int)cudaGetLastError();
}
