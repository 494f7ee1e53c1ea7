// K10 unpack_bits: the device half of the bit-packed bool upload.
//
// Replaces: swarmkit_tpu/ops/bitpack.py `unpack_bits` (:26), which
// `ops/raft_replay.py` `unpack_acks` (:83) calls for the raft ack matrix:
//   out[r, c] = (packed[r, c >> 3] >> (c & 7)) & 1
// for packed uint8[R, W] (W >= ceil(C / 8), little-endian bit order) into
// bool[R, C] (one byte per value, as torch.bool is).
//
// Bound on this card: memory. It reads R * ceil(C / 8) bytes and writes
// R * C bytes (5.6 MB at 5 x 1,000,000: about 1.7 us at 3.35 TB/s); a shift
// and a mask per output byte.
//
// Design: one thread per output byte, neighbouring threads on neighbouring
// bytes of a row (the writes coalesce; eight neighbours read one packed
// byte, which the cache serves). Rows run over the grid's y dimension and
// columns over x, each with a stride loop, so no index needs a division.
#include <cstdint>
#include <cuda_runtime.h>

namespace skt {

__global__ void unpack_bits_kernel(const uint8_t* __restrict__ packed,
                                   uint8_t* __restrict__ out, int R, int W,
                                   int C) {
  for (int r = blockIdx.y; r < R; r += gridDim.y) {
    const uint8_t* row = packed + (int64_t)r * W;
    uint8_t* dst = out + (int64_t)r * C;
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < C;
         c += gridDim.x * blockDim.x)
      dst[c] = (row[c >> 3] >> (c & 7)) & 1;
  }
}

}  // namespace skt

extern "C" int skt_unpack_bits(const void* packed, void* out, int R, int W,
                               int C, void* stream) {
  const int threads = 256;
  const int bx = (C + threads - 1) / threads;
  const dim3 grid(bx < 65535 ? bx : 65535, R < 65535 ? R : 65535);
  skt::unpack_bits_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (uint8_t*)out, R, W, C);
  return (int)cudaGetLastError();
}
