// K1 static_mask: the static eligibility mask[G, N] of the placement step,
// on one device (`skt_static_mask`) or over k node shards of one card in
// one launch (`skt_sharded_static_mask`: k masks [G, n], one a shard).
//
// Replaces: swarmkit_tpu/ops/placement.py `build_static_mask` (:67) and
// `_vol_topo_ok` (:38): ready AND constraints (== / != on the node's
// interned key column) AND platform (wildcard 0, pad row -2) AND plugins
// AND the host-side extra mask AND the CSI volume-topology rows (AND over
// mounts of OR over that mount's rows of AND over the row's segments); the
// sharded entry as swarmkit_tpu/parallel/mesh.py's fused step (`_fused_step`
// :276) runs it with the node axis sharded.
//
// Bound on this card: it must read extra_mask and write the mask, 2 bytes
// per (group, node), plus the node tables once; at 20 groups x 10k nodes
// that is under 1 MB, well under a microsecond of memory time, so launch
// latency (and the host's call) dominates.
//
// Design: one body behind both entries, a thread per (node, group, shard):
// a grid of (node tiles of THREADS, G, k), so every thread of a block has
// one group and one shard (the group's rows are uniform loads across the
// block, the stores of a warp one coalesced run) and no thread divides.
// The sharded entry reaches shard b's node arrays through row b of a
// pointer table (MaskShard, 5 pointers) and writes mask b at out + b * G *
// n; the one-device entry passes its arrays by value (no table). Three
// other bodies ran slower on the card at 8 shards x 16,384 nodes x 16
// groups: a thread walking 8 groups of one node with their rows staged in
// shared memory (a chain of 8 dependent passes a thread: 1.1x, and 2.3x at
// one device), every leg evaluated without the short-circuits (1.8x), and
// a 1-D grid over (group, node) with a 32-bit division (1.2x, though 5%
// faster at one device). The plugin leg is "some required plugin is
// missing on the node", a boolean test equal to the reference's fp32
// einsum > 0.5 while PL < 2^24. Gathered key columns are clamped to [0,
// K) as the reference's gathers are; volume mounts outside [0, 4) are no
// leg.
#include <cstdint>
#include <cuda_runtime.h>

namespace skt {
namespace {

constexpr int VOL_TOPO_MOUNTS = 4;  // scheduler/encode.py VOL_TOPO_MOUNTS
constexpr int THREADS = 256;        // nodes a block
constexpr int MAX_GRID_YZ = 65535;  // groups, shards

// One shard's node-axis inputs: a row of the sharded entry's pointer table
// (5 pointers, in this order; ops/placement.py `sharded_static_mask`).
struct MaskShard {
  const uint8_t* ready;         // [n]
  const int32_t* node_val;      // [n, K]
  const int32_t* node_plat;     // [n, 2]
  const uint8_t* node_plugins;  // [n, PL]
  const uint8_t* extra;         // [G, n]
};

// The one-device entry's node arrays, by value.
struct OneSet {
  MaskShard s;
  __device__ __forceinline__ MaskShard get(int) const { return s; }
};

// The sharded entry's node arrays: the pointer table in device memory.
struct ShardTable {
  const MaskShard* rows;  // [k]
  __device__ __forceinline__ MaskShard get(int b) const { return rows[b]; }
};

struct GroupRows {
  const int32_t* constraints;  // [G, C, 3]
  const int32_t* plat_req;     // [G, P, 2]
  const uint8_t* req_plugins;  // [G, PL]
  const int32_t* vol_topo;     // [G, VA, W]
};

struct Dims {
  int G, n, K, PL, C, P, VA, W;
};

__device__ __forceinline__ int clamp_col(int c, int K) {
  return c < 0 ? 0 : (c >= K ? K - 1 : c);
}

template <class Nodes>
__global__ void __launch_bounds__(THREADS)
mask_kernel(Nodes nodes, GroupRows gr, uint8_t* out, Dims d) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= d.n) return;
  const int g = blockIdx.y, b = blockIdx.z;
  const MaskShard s = nodes.get(b);
  bool ok = s.ready[i] && s.extra[(int64_t)g * d.n + i];

  const int32_t* nv = s.node_val + (int64_t)i * d.K;
  const int32_t* cr = gr.constraints + (int64_t)g * d.C * 3;
  for (int c = 0; ok && c < d.C; ++c) {
    const int32_t* row = cr + 3 * c;
    if (row[0] < 0) continue;  // padding
    const bool hit = nv[clamp_col(row[0], d.K)] == row[2];
    ok = row[1] == 0 ? hit : !hit;
  }

  if (ok) {
    bool has_plat = false, plat_hit = false;
    const int32_t os = s.node_plat[(int64_t)i * 2];
    const int32_t arch = s.node_plat[(int64_t)i * 2 + 1];
    const int32_t* pr = gr.plat_req + (int64_t)g * d.P * 2;
    for (int p = 0; p < d.P; ++p) {
      const int32_t* row = pr + 2 * p;
      if (row[0] <= -2) continue;  // pad row
      has_plat = true;
      plat_hit |= (row[0] == 0 || row[0] == os) &&
                  (row[1] == 0 || row[1] == arch);
    }
    ok = !has_plat || plat_hit;
  }

  const uint8_t* rp = gr.req_plugins + (int64_t)g * d.PL;
  const uint8_t* np = s.node_plugins + (int64_t)i * d.PL;
  for (int p = 0; ok && p < d.PL; ++p) ok = !(rp[p] && !np[p]);

  if (ok && d.VA > 0) {
    // bit m: the group has a row of mount m / one of them passes
    unsigned has_m = 0, m_ok = 0;
    const int32_t* vr = gr.vol_topo + (int64_t)g * d.VA * d.W;
    for (int v = 0; v < d.VA; ++v) {
      const int32_t* row = vr + (int64_t)v * d.W;
      const int32_t m = row[0];
      if (m < 0 || m >= VOL_TOPO_MOUNTS) continue;  // no mount: no leg
      bool row_ok = true;
      for (int sg = 0; sg < (d.W - 1) / 2; ++sg) {
        const int32_t key = row[1 + 2 * sg];
        row_ok &= key < 0 || nv[clamp_col(key, d.K)] == row[2 + 2 * sg];
      }
      has_m |= 1u << m;
      if (row_ok) m_ok |= 1u << m;
    }
    ok = (has_m & ~m_ok) == 0;
  }
  out[((int64_t)b * d.G + g) * d.n + i] = ok;
}

template <class Nodes>
int launch(const Nodes& nodes, const GroupRows& gr, uint8_t* out, int k,
           const Dims& d, cudaStream_t stream) {
  if (k < 1 || d.G < 0 || d.n < 0 || d.K < 1)
    return (int)cudaErrorInvalidValue;
  if (d.G == 0 || d.n == 0) return 0;
  if (d.G > MAX_GRID_YZ || k > MAX_GRID_YZ) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((d.n + THREADS - 1) / THREADS), (unsigned)d.G,
                  (unsigned)k);
  mask_kernel<Nodes><<<grid, THREADS, 0, stream>>>(nodes, gr, out, d);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace skt

extern "C" int skt_static_mask(const void* ready, const void* node_val,
                               const void* node_plat, const void* node_plugins,
                               const void* constraints, const void* plat_req,
                               const void* req_plugins, const void* extra_mask,
                               const void* vol_topo, void* out, int G, int N,
                               int K, int PL, int C, int P, int VA, int W,
                               void* stream) {
  const skt::OneSet nodes{{(const uint8_t*)ready, (const int32_t*)node_val,
                           (const int32_t*)node_plat,
                           (const uint8_t*)node_plugins,
                           (const uint8_t*)extra_mask}};
  const skt::GroupRows gr{(const int32_t*)constraints,
                          (const int32_t*)plat_req,
                          (const uint8_t*)req_plugins,
                          (const int32_t*)vol_topo};
  return skt::launch(nodes, gr, (uint8_t*)out, 1,
                     skt::Dims{G, N, K, PL, C, P, VA, W},
                     (cudaStream_t)stream);
}

// k shards of n nodes in one launch: `rows` is the pointer table int64[k,
// 5] (ready, node_val, node_plat, node_plugins, extra_mask of each shard),
// the group-side tables one copy, `out` the k masks bool[k, G, n].
extern "C" int skt_sharded_static_mask(const void* rows,
                                       const void* constraints,
                                       const void* plat_req,
                                       const void* req_plugins,
                                       const void* vol_topo, void* out, int k,
                                       int G, int n, int K, int PL, int C,
                                       int P, int VA, int W, void* stream) {
  const skt::ShardTable nodes{(const skt::MaskShard*)rows};
  const skt::GroupRows gr{(const int32_t*)constraints,
                          (const int32_t*)plat_req,
                          (const uint8_t*)req_plugins,
                          (const int32_t*)vol_topo};
  return skt::launch(nodes, gr, (uint8_t*)out, k,
                     skt::Dims{G, n, K, PL, C, P, VA, W},
                     (cudaStream_t)stream);
}
