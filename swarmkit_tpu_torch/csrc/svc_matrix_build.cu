// K8 svc_matrix_build: the resident [S, N] per-service count matrix, made
// on the card from its nonzero cells instead of shipped dense.
//
// Replaces: the cold-upload svc-matrix branches of swarmkit_tpu/ops/
// resident.py `_upload_full` (:351-380) and the single-device form of
// `_sharded_zeros` (:150-158):
//   out = zeros(S * N); out[idx[i]] += val[i] for i < nnz
// (a FLAT scatter-add, viewed as [S, N] by the caller). nnz == 0 is the
// all-zero branch. Indices come in any order; the add is atomic, so a
// repeated index sums as the reference's `.at[].add` does. Indices outside
// [0, cells) are skipped.
//
// Bound on this card: memory in principle, 4 bytes written per cell and 8
// read per pair: 2.1 MB and 0.00063 ms at the node-heavy tick's 32 x 16,384
// with 277 pairs. In practice launch latency bounds it: at that size one
// launch costs more than the bytes, and the zero fill followed by a
// scatter launch paid two.
//
// Design: one launch where the pairs are few. The cells are cut into one
// contiguous share a block (a multiple of 4 cells), over a grid of at most
// kBlocksPerSm blocks on each SM. A block zeroes its share with 16-byte
// stores (int4; the output must be 16-byte aligned, as PyTorch's allocator
// gives it), waits on its own barrier, then adds the pairs whose index
// falls in its share (the first kPre * kThreads of them loaded before the
// zeros, so that their reads overlap the stores). No block touches
// another's cells, so no grid-wide barrier is needed. Every block reads
// all nnz indices, so the host takes this form only while nnz * blocks <=
// cells (the index reads of the whole grid no more than the cells it
// writes, and those reads hit L2). Above that, two launches: the same zero
// fill, then one thread a pair (grid-stride) adding into the whole
// matrix.
#include <cstdint>
#include <cuda_runtime.h>

namespace skt {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kPre = 4;         // pairs a thread loads before the zeros

int sm_count() {
  static int sms = 0;   // the card's SM count, read once
  if (sms == 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
    sms = n;
  }
  return sms;
}

// Block b owns cells [b * share, min((b + 1) * share, cells)); share is a
// multiple of 4. With nnz > 0 the block then adds the pairs in its share:
// a thread loads its first kPre pairs before the zero stores, so their
// reads are in flight while the block zeroes, and adds them after the
// block's barrier; pairs beyond kPre * kThreads are read after it.
__global__ void __launch_bounds__(kThreads)
    build_kernel(const int32_t* __restrict__ idx,
                 const int32_t* __restrict__ val, int32_t* __restrict__ out,
                 long long cells, int nnz, long long share) {
  const long long lo = (long long)blockIdx.x * share;
  const long long hi = lo + share < cells ? lo + share : cells;
  int32_t pi[kPre], pv[kPre];
#pragma unroll
  for (int r = 0; r < kPre; ++r) {
    const int i = r * kThreads + threadIdx.x;
    pi[r] = i < nnz ? idx[i] : -1;
    pv[r] = i < nnz ? val[i] : 0;
  }
  const long long n4 = (hi - lo) >> 2;
  int4* o4 = reinterpret_cast<int4*>(out + lo);
  for (long long i = threadIdx.x; i < n4; i += kThreads)
    o4[i] = make_int4(0, 0, 0, 0);
  for (long long c = lo + (n4 << 2) + threadIdx.x; c < hi; c += kThreads)
    out[c] = 0;
  if (nnz == 0) return;   // uniform across the grid
  __syncthreads();        // the share's zeros before its adds
#pragma unroll
  for (int r = 0; r < kPre; ++r)
    if (pi[r] >= lo && pi[r] < hi) atomicAdd(out + pi[r], pv[r]);
  for (int i = kPre * kThreads + threadIdx.x; i < nnz; i += kThreads) {
    const int32_t c = idx[i];
    if (c >= lo && c < hi) atomicAdd(out + c, val[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
    scatter_add_kernel(const int32_t* __restrict__ idx,
                       const int32_t* __restrict__ val, int32_t* out,
                       long long cells, int nnz) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < nnz;
       i += gridDim.x * kThreads) {
    const int32_t c = idx[i];
    if (c >= 0 && c < cells) atomicAdd(out + c, val[i]);
  }
}

}  // namespace skt

// One launch while nnz * blocks <= cells (the zeros and the adds, a share
// a block), else two (the zeros, then the adds).
extern "C" int skt_svc_matrix_build(const void* idx, const void* val,
                                    void* out, long long cells, int nnz,
                                    void* stream) {
  using namespace skt;
  if (cells <= 0) return (int)cudaSuccess;
  if ((uintptr_t)out & 15) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long most = (long long)kBlocksPerSm * sm_count();
  const long long units = (cells + 3) >> 2;         // 4 cells a unit
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > most) blocks = most;
  const long long share = ((units + blocks - 1) / blocks) << 2;
  blocks = (cells + share - 1) / share;              // no empty block
  const bool fused = (long long)nnz * blocks <= cells;
  build_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      (const int32_t*)idx, (const int32_t*)val, (int32_t*)out, cells,
      fused ? nnz : 0, share);
  if (fused || nnz <= 0) return (int)cudaGetLastError();
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long grid = ((long long)nnz + kThreads - 1) / kThreads;
  if (grid > most) grid = most;
  scatter_add_kernel<<<(unsigned)grid, kThreads, 0, st>>>(
      (const int32_t*)idx, (const int32_t*)val, (int32_t*)out, cells, nnz);
  return (int)cudaGetLastError();
}
