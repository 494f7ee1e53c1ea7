// The water-fill group step of the placement scan, one body for two
// kernels: K3 (tree_fill.cu: one shard of N nodes, LMAX > 0) and K20
// (sharded_water_fill.cu: k node shards on one card, LMAX >= 0, L = 0 the
// flat fill).
//
// Replaces: swarmkit_tpu/ops/placement.py `_schedule_core` step (:336-374)
// with `_flat_water_fill` (:173), `_tree_water_fill` (:209) and
// `_segmented_pour` (:132), one device and sharded (parallel/mesh.py
// `_fused_step` :276). It computes what the plain versions compute, bit
// for bit (ops/placement.py `tree_fill_step_plain`, parallel/fill.py
// `sharded_water_fill_step_plain`).
//
// Bound on this card: a step reads and writes a few tens of bytes a node
// (~11 MB at 131,072 nodes, 3 us of memory time). What bounds it is
// latency: chains of dependent reductions over the nodes, each a barrier.
//
// Design. The reference searches each water level by a 31-step bisection
// (and the leaf remainder by a 64-step one), one barrier a step. Here:
//  * Several bits a pass. F(x) = sum min(cap, max(0, x - k)) never
//    decreases and F(0) = 0, so the bisection returns the largest x in
//    [0, 2^30] with F(x) <= q. A pass splits each open range [lo, hi] at
//    the points t_j = lo + floor(j * w / WAYS) (w = hi - lo + 1), sums
//    F(t_j) for every j at once and keeps [t_J, t_{J+1} - 1] for the
//    largest J with F(t_J) <= q: 8 passes in place of 31 (BITS = 4). An
//    item adds to at most two bins of its slot: with j0 the first point
//    above k and j1 the first at or above k + cap it is partial (t_j - k)
//    on [j0, j1) and saturated (cap) from j1, so count[j0] += 1, ksum[j0]
//    -= k, and count[j1] -= 1, ksum[j1] += k, capsum[j1] += cap; prefix
//    sums give F(t_j) = count * t_j + ksum + capsum in uint32 (exact: F <
//    2^31). The leaf remainder is the rem-th smallest boundary key (totals
//    + c) * N_padded + global index (int64, distinct) of each leaf, found
//    the same way from the count of keys below each point (~6 passes at
//    131,072 nodes).
//  * One chain whatever LMAX. The branch aggregates of every spread level
//    (service, capacity and node counts, the parent's minimum) come from
//    one pass over the nodes; the pour down the levels then runs on the
//    branch slots alone, behind block barriers, the level's children
//    staged in shared memory.
//  * Blocks decoupled from shards. The C blocks of one thread block
//    cluster (1, 2, 4, 8 or 16 by node count, about NODES_PER_BLOCK a
//    block) are dealt the global node range in chunks of 32, round robin,
//    so a group eligible on one shard still loads every block and a warp
//    reads 32 neighbouring nodes. A node's arrays are reached through the
//    policy (OneShard: K3's tensors; Shards: the shard row idx / n).
//    Cross-block sums are integer atomics into one copy in device memory
//    (the "home"), published by the cluster barrier; the capacity sum, the
//    largest key and K3's branch bound go through distributed shared
//    memory.
//  * Per-step state on chip. A block keeps its nodes' cap, k, leaf and
//    secondary key in shared memory while they fit (~9,500 nodes a block;
//    device scratch above, a route by shape). With at most SLOT_SMEM
//    branch slots (the shared route) every block also keeps the slot state
//    (quotas, ranges, remainders, point tables of t_j) there, sums a pass
//    into private bins before one flush into the home, and takes every
//    decision itself, the same in every block: one cluster barrier a pass,
//    the home bins rotating over three buffers (the one two passes ahead
//    is zeroed while the current one is read). Above SLOT_SMEM slots (the
//    global route, a route by shape) the slot state is one copy in device
//    scratch, block 0 decides and a pass costs two barriers.
//  * 16 lanes settle a slot's pass together (a point each: a shuffle scan
//    of the bins, a vote for J); a node finds its point from the slot's
//    table with four compares; lanes of a warp with one bin add in one
//    atomic.
//  * Branch slots bounded by the problem: NB is one past the largest
//    branch id (K20: from the caller; K3: found in the step's first pass).
//
// Cluster barriers a step (C = 1 turns each into __syncthreads): 2 (K3:
// 3) + 8 water passes + 1 + the key passes, whatever LMAX; the one-bit
// bodies took ~62 a level and ~66 + the key steps at the leaf.
//
// int32 intermediates keep the one-device bounds: every sum over nodes is
// bounded by the group's capacity sum, taken in 64 bits and refused from
// 2^31 (flag set, counts zeroed, nothing folded); ranges in [0, 2^30];
// node counts and ranks < N padded < 2^31; keys int64.
#pragma once

#include <climits>
#include <cooperative_groups.h>

#include "mesh.cuh"

namespace skt {
namespace wf {

namespace cg = cooperative_groups;

constexpr int BITS = 4;                  // bits a pass settles
constexpr int WAYS = 1 << BITS;          // sub-ranges a pass; points 1..15
constexpr int BIN = 3;                   // words a (slot, point): count,
                                         // ksum, capsum (uint32)
constexpr int SLOT_BINS = WAYS * BIN;    // 48 words a slot
constexpr int THREADS = 1024;
constexpr int LANES = 16;                // lanes that settle a slot's pass
constexpr int SLOT_SMEM = 192;           // slots of the shared route
constexpr int SLOT_I32 = 16;             // int32 slot arrays (+ 2 words)
constexpr int NODE_I32 = 4;              // node arrays: cap, k, leaf, sec
constexpr int MAX_CLUSTER = 16;
constexpr int NODES_PER_BLOCK = 1024;    // about one node a thread
constexpr int32_t NOT_BOUNDARY = INT32_MIN;
constexpr unsigned FULL = 0xffffffffu;

// int32 words of the slot state for nb slots: 16 arrays, a flag and a pad
// word, klo/khi (int64), the branch-pour bins.
__host__ __device__ constexpr long long slot_words(long long nb) {
  return SLOT_I32 * nb + 2 + 4 * nb + SLOT_BINS * nb;
}
constexpr size_t SLOT_BYTES = (size_t)slot_words(SLOT_SMEM) * 4;
// The shared route's point tables: t_0..t_15 of every slot's open range
// (int64), so a node finds its sub-range with four compares.
constexpr size_t PTS_OFFSET = (SLOT_BYTES + 15) / 16 * 16;
constexpr size_t NODE_OFFSET = PTS_OFFSET + (size_t)SLOT_SMEM * WAYS * 8;

// Home buffers: 3 rotating bins on the shared route, 1 on the global.
__host__ __device__ constexpr int home_bufs(long long nb) {
  return nb <= SLOT_SMEM ? 3 : 1;
}
// int32 words of the home (cross-block sums): the branch aggregates of
// every level [L][4][nb] (kc, cc, cnt, par), the leaves' given sums [nb],
// a pad word, the bins.
__host__ __device__ constexpr long long home_words(long long nb, int L) {
  return 4LL * L * nb + nb + 1 + (long long)home_bufs(nb) * SLOT_BINS * nb;
}
// A block's share of the nodes: warp-sized chunks of the global range
// dealt round robin over the C blocks (chunk c to block c % C), so the
// nodes of any shard or group spread over every block and a warp reads 32
// neighbouring nodes. Local node j of block r is global node
// ((j / 32) * C + r) * 32 + j % 32; a block has `per` local slots.
constexpr int CHUNK = 32;
__host__ __device__ constexpr long long block_nodes(long long Np, int C) {
  return ((Np + CHUNK - 1) / CHUNK + C - 1) / C * CHUNK;
}
// int32 words of the device-scratch node arrays for Np nodes, any cluster.
__host__ __device__ constexpr long long node_words(long long Np) {
  return NODE_I32 * (Np + (long long)CHUNK * MAX_CLUSTER);
}

// int32 words of device scratch a step with nb slots needs (the global
// route adds its slot state after the home).
__host__ __device__ constexpr long long scratch_words(long long nb, int L) {
  return home_words(nb, L) + (nb > SLOT_SMEM ? slot_words(nb) : 0);
}

// ------------------------------------------------------------ the nodes
// One node's arrays, as the one-device kernels index them (common.cuh).
struct NodeRef {
  GroupArgs a;
  NodeState s;
  const int32_t* ranks;  // [G, L, n]
  int32_t* out;          // [G, n]
  int i, n;
};

// K3: one shard of N nodes.
struct OneShard {
  GroupArgs a;
  NodeState s;
  const int32_t* ranks;
  int32_t* out;
  int N;
  __device__ __forceinline__ long long count() const { return N; }
  __device__ __forceinline__ int32_t n_tasks(int g) const {
    return a.n_tasks[g];
  }
  __device__ __forceinline__ int32_t svc_row(int g) const {
    return a.svc_idx[g];
  }
  __device__ __forceinline__ NodeRef ref(long long idx) const {
    return NodeRef{a, s, ranks, out, (int)idx, N};
  }
};

// K20: k shards of n nodes (mesh.cuh ShardRow); idx = shard * n + i.
struct Shards {
  GroupSide gs;
  const ShardRow* rows;  // [k]
  int k, n;
  __device__ __forceinline__ long long count() const {
    return (long long)k * n;
  }
  __device__ __forceinline__ int32_t n_tasks(int g) const {
    return gs.n_tasks[g];
  }
  __device__ __forceinline__ int32_t svc_row(int g) const {
    return gs.svc_idx[g];
  }
  __device__ __forceinline__ NodeRef ref(long long idx) const {
    const int b = (int)(idx / n);
    const ShardRow r = rows[b];
    return NodeRef{shard_group_args(gs, r), shard_state(r), r.spread_rank,
                   r.out, (int)(idx - (long long)b * n), n};
  }
};

// ------------------------------------------------------- launch params
struct Params {
  int g, R, PV, L;
  int NB;                 // branch slots; 0: found on the device (K3)
  int32_t* flags;         // [G]
  int32_t* gnode;         // node_words(Np), or null: nodes in shared memory
  int32_t* scratch;       // scratch_words(NB, L) int32 (K3: for NB = N)
  long long* scratch64;   // [2, NB] int64 (klo, khi of the global route)
};

// ---------------------------------------------------- block helpers
// Works for any block size (a multiple of 32 on the card).
__device__ __forceinline__ long long block_reduce(long long v, bool take_max,
                                                  long long* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  const int wl = blockDim.x < 32 ? (int)blockDim.x : 32;
  for (int o = 16; o > 0; o >>= 1) {
    const long long u = __shfl_down_sync(FULL, v, o);
    if (lane + o < wl) v = take_max ? (u > v ? u : v) : v + u;
  }
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    long long r = lane < nw ? red[lane] : (take_max ? LLONG_MIN : 0);
    for (int o = 16; o > 0; o >>= 1) {
      const long long u = __shfl_down_sync(FULL, r, o);
      if (lane + o < wl) r = take_max ? (u > r ? u : r) : r + u;
    }
    if (lane == 0) red[0] = r;
  }
  __syncthreads();
  return red[0];
}

// Exclusive prefix sum of one int per thread, in thread order.
__device__ __forceinline__ int32_t block_excl_scan(int32_t v, int32_t* sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  int32_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31 || (int)threadIdx.x == (int)blockDim.x - 1) sh[w] = x;
  __syncthreads();
  if (w == 0) {
    int32_t s = lane < nw ? sh[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) sh[lane] = s;
  }
  __syncthreads();
  return (w > 0 ? sh[w - 1] : 0) + x - v;
}

// Adds into the bin triple at bins + key * BIN: every lane of the warp
// calls; key < 0 adds nothing. Where the whole warp has one key (the flat
// fill's one leaf, a pass's common point) its sums go in one atomic each.
__device__ __forceinline__ void agg_add3(uint32_t* bins, int key, uint32_t a,
                                         uint32_t b, uint32_t c) {
  const int k0 = __shfl_sync(FULL, key, 0);
  if (__all_sync(FULL, key == k0)) {
    a = __reduce_add_sync(FULL, a);
    b = __reduce_add_sync(FULL, b);
    c = __reduce_add_sync(FULL, c);
    if (key < 0 || (threadIdx.x & 31)) return;
  } else if (key < 0) {
    return;
  }
  uint32_t* p = bins + (long long)key * BIN;
  if (a) atomicAdd(p, a);
  if (b) atomicAdd(p + 1, b);
  if (c) atomicAdd(p + 2, c);
}

__device__ __forceinline__ void agg_add1(uint32_t* p, int key, uint32_t a,
                                         int stride) {
  const int k0 = __shfl_sync(FULL, key, 0);
  if (__all_sync(FULL, key == k0)) {
    a = __reduce_add_sync(FULL, a);
    if (key < 0 || (threadIdx.x & 31)) return;
  } else if (key < 0) {
    return;
  }
  if (a) atomicAdd(p + (long long)key * stride, a);
}

// ------------------------------------------------------ the search
// t_j of the range starting at lo of width w (j in [0, WAYS]; t_WAYS is
// one past the range).
__device__ __forceinline__ long long point(long long lo, long long w, int j) {
  return lo + (w >> BITS) * j + (((w & (WAYS - 1)) * j) >> BITS);
}

// The first j in [1, WAYS] with t_j > x (WAYS when no point below WAYS is).
__device__ __forceinline__ int first_above(long long lo, long long w,
                                           long long x) {
  int a = 1, b = WAYS;
  while (a < b) {
    const int m = (a + b) >> 1;
    if (point(lo, w, m) > x) {
      b = m;
    } else {
      a = m + 1;
    }
  }
  return a;
}

// The same from a slot's point table t[0..WAYS-1] (null: computed).
__device__ __forceinline__ int first_above_at(const long long* t,
                                              long long lo, long long w,
                                              long long x) {
  if (!t) return first_above(lo, w, x);
  int j = 0;
  for (int st = WAYS / 2; st > 0; st >>= 1)
    if (t[j + st] <= x) j += st;
  return j + 1;
}

__device__ __forceinline__ void fill_points(long long* t, long long lo,
                                            long long hi) {
  const long long w = hi - lo + 1;
  for (int j = 0; j < WAYS; ++j) t[j] = point(lo, w, j);
}

// One item's (k, cap > 0) share of F at the points of [lo, hi] (hi > lo),
// into slot `slot`'s bins; act false adds nothing. Every lane calls. pts:
// the slot's point table, or null.
__device__ __forceinline__ void water_add(uint32_t* bins, int slot,
                                          int32_t lo, int32_t hi, int32_t k,
                                          int32_t cap, bool act,
                                          const long long* pts = nullptr) {
  int key0 = -1, key1 = -1;
  uint32_t c1 = 0, k1 = 0, p1 = 0;
  uint32_t k0 = 0;
  if (act) {
    const long long w = (long long)hi - lo + 1;
    const int j0 = first_above_at(pts, lo, w, k);
    const int j1 = first_above_at(pts, lo, w, (long long)k + cap - 1);
    if (j0 < j1) {
      key0 = slot * WAYS + j0;
      k0 = 0u - (uint32_t)k;
    }
    if (j1 < WAYS) {
      key1 = slot * WAYS + j1;
      p1 = (uint32_t)cap;
      if (j0 < j1) {
        c1 = 0xffffffffu;
        k1 = (uint32_t)k;
      }
    }
  }
  agg_add3(bins, key0, key0 >= 0 ? 1u : 0u, k0, 0u);
  agg_add3(bins, key1, c1, k1, p1);
}

// A bin word: the home's through L2 (other blocks' atomics), a block's own
// bins (shared memory on the shared route) as they are.
template <bool HOME>
__device__ __forceinline__ uint32_t bin_word(const uint32_t* p) {
  return HOME ? __ldcg(p) : *p;
}

// A slot's pass is settled by H lanes together (LANES: one point a lane;
// the slots of a pass go H lanes each): lane h holds points [h * PER,
// (h + 1) * PER). Every lane of the warp calls; act false: an
// idle group. zero: the bins are cleared once read. pts: the slot's point
// table, refilled for the new range (or null).
//
// Water: the largest J with F(t_J) <= q, from prefix sums of the bins.
template <int H, bool HOME>
__device__ __forceinline__ void water_decide(uint32_t* bin, int32_t* lo_p,
                                             int32_t* hi_p, int32_t q,
                                             long long* pts, bool act,
                                             bool zero) {
  constexpr int PER = WAYS / H;
  const int h = (int)(threadIdx.x % H);
  const int32_t lo = act ? *lo_p : 0, hi = act ? *hi_p : 0;
  const long long w = (long long)hi - lo + 1;
  const bool open = act && w > 1;
  uint32_t c[PER], k[PER], p[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = h * PER + i;
    c[i] = k[i] = p[i] = 0;
    if (open && j > 0) {
      c[i] = bin_word<HOME>(bin + j * BIN);
      k[i] = bin_word<HOME>(bin + j * BIN + 1);
      p[i] = bin_word<HOME>(bin + j * BIN + 2);
    }
    if (i) {
      c[i] += c[i - 1];
      k[i] += k[i - 1];
      p[i] += p[i - 1];
    }
  }
  uint32_t sc = c[PER - 1], sk = k[PER - 1], sp = p[PER - 1];
#pragma unroll
  for (int o = 1; o < H; o <<= 1) {  // the lanes' totals, scanned
    const uint32_t uc = __shfl_up_sync(FULL, sc, o, H);
    const uint32_t uk = __shfl_up_sync(FULL, sk, o, H);
    const uint32_t up = __shfl_up_sync(FULL, sp, o, H);
    if (h >= o) {
      sc += uc;
      sk += uk;
      sp += up;
    }
  }
  sc -= c[PER - 1];
  sk -= k[PER - 1];
  sp -= p[PER - 1];
  int J = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = h * PER + i;
    const uint32_t f =
        (sc + c[i]) * (uint32_t)point(lo, w, j) + sk + k[i] + sp + p[i];
    J += open && j > 0 && (int32_t)f <= q;  // F(t_j) <= q on 1..J
  }
#pragma unroll
  for (int o = H / 2; o > 0; o >>= 1) J += __shfl_xor_sync(FULL, J, o, H);
  if (open) {
    const long long nlo = point(lo, w, J), nhi = point(lo, w, J + 1) - 1;
    if (h == 0) {
      *lo_p = (int32_t)nlo;
      *hi_p = (int32_t)nhi;
    }
    if (pts)
#pragma unroll
      for (int i = 0; i < PER; ++i)
        pts[h * PER + i] = point(nlo, nhi - nlo + 1, h * PER + i);
  }
  if (zero && act)
#pragma unroll
    for (int i = 0; i < PER; ++i)
      for (int b = 0; b < BIN; ++b) bin[(h * PER + i) * BIN + b] = 0;
}

// Keys: the largest J whose count of keys below t_J stays under rem.
template <int H>
__device__ __forceinline__ void key_decide(uint32_t* bin, long long* lo_p,
                                           long long* hi_p, int32_t* below_p,
                                           int32_t rem, long long* pts,
                                           bool act, bool zero) {
  constexpr int PER = WAYS / H;
  const int h = (int)(threadIdx.x % H);
  const long long lo = act ? *lo_p : 0, hi = act ? *hi_p : 0;
  const int32_t below = act ? *below_p : 0;
  const long long w = hi - lo + 1;
  const bool open = act && rem > 0 && w > 1;
  int32_t c[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = h * PER + i;
    c[i] = open && j > 0 ? (int32_t)bin_word<true>(bin + j * BIN) : 0;
    if (i) c[i] += c[i - 1];
  }
  int32_t sc = c[PER - 1];
#pragma unroll
  for (int o = 1; o < H; o <<= 1) {
    const int32_t u = __shfl_up_sync(FULL, sc, o, H);
    if (h >= o) sc += u;
  }
  sc += below - c[PER - 1];  // keys below this lane's first point
  int J = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = h * PER + i;
    J += open && j > 0 && sc + c[i] < rem;  // count(t_j) < rem on 1..J
  }
#pragma unroll
  for (int o = H / 2; o > 0; o >>= 1) J += __shfl_xor_sync(FULL, J, o, H);
  int32_t cJ = 0;  // the count below t_J, from the lane that holds J
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (h * PER + i == J) cJ = sc + c[i];
#pragma unroll
  for (int o = H / 2; o > 0; o >>= 1) cJ += __shfl_xor_sync(FULL, cJ, o, H);
  if (open) {
    const long long nlo = point(lo, w, J), nhi = point(lo, w, J + 1) - 1;
    if (h == 0) {
      *lo_p = nlo;
      *hi_p = nhi;
      *below_p = J ? cJ : below;
    }
    if (pts)
#pragma unroll
      for (int i = 0; i < PER; ++i)
        pts[h * PER + i] = point(nlo, nhi - nlo + 1, h * PER + i);
  }
  if (zero && act)
#pragma unroll
    for (int i = 0; i < PER; ++i)
      for (int b = 0; b < BIN; ++b) bin[(h * PER + i) * BIN + b] = 0;
}

__device__ __forceinline__ long long ceil_ways(long long w) {
  return (w + WAYS - 1) >> BITS;
}

// ------------------------------------------------------- slot state
struct Slots {
  int32_t *quota, *newq, *capp, *qq, *lo, *hi, *fil, *off, *cum, *bnd, *rem,
      *below, *kc, *cap, *par, *vld, *any;
  long long *klo, *khi;
  uint32_t* bins;  // [nb][WAYS][BIN] the branch pour's bins
};

__device__ __forceinline__ Slots slots_at(int32_t* w, long long* w64, int nb) {
  Slots s;
  int32_t** arr[SLOT_I32] = {&s.quota, &s.newq, &s.capp, &s.qq,
                             &s.lo,    &s.hi,   &s.fil,  &s.off,
                             &s.cum,   &s.bnd,  &s.rem,  &s.below,
                             &s.kc,    &s.cap,  &s.par,  &s.vld};
  for (int i = 0; i < SLOT_I32; ++i) *arr[i] = w + (long long)i * nb;
  s.any = w + (long long)SLOT_I32 * nb;
  long long* k64 = w64 ? w64 : (long long*)(w + (long long)SLOT_I32 * nb + 2);
  s.klo = k64;
  s.khi = k64 + nb;
  s.bins = (uint32_t*)(w + (long long)SLOT_I32 * nb + 2 + 4LL * nb);
  return s;
}

// ------------------------------------------------- the step, per block
template <class Nodes>
struct Step {
  Nodes nd;
  Params pm;
  long long* red;   // __shared__ [32]
  int32_t* sh;      // __shared__ [32]
  long long* xch;   // __shared__ [2]: the block's cross-block partial
  long long* bc;    // __shared__ [1]
  int C, rank, tid, nt;
  int xp;           // the exchange slot of the next cross-block reduction
  bool pending;     // a remote read of a block's slot since the last barrier

  __device__ __forceinline__ void sync_all() {
    if (C == 1) {
      __syncthreads();
    } else {
      cg::this_cluster().sync();
    }
    pending = false;
  }

  // The cluster-wide sum (or max) of every thread's v: the block's
  // reduction into its exchange slot, the barrier, and warp 0 folding the
  // C slots through distributed shared memory.
  __device__ long long cluster_reduce(long long v, bool take_max) {
    v = block_reduce(v, take_max, red);
    if (C == 1) return v;
    if (tid == 0) xch[xp] = v;
    sync_all();
    if (tid < 32) {
      const int lane = tid, wl = nt < 32 ? nt : 32;
      long long t = take_max ? LLONG_MIN : 0;
      for (int r = lane; r < C; r += wl) {
        const long long u = *cg::this_cluster().map_shared_rank(xch + xp, r);
        t = take_max ? (u > t ? u : t) : t + u;
      }
      for (int o = 16; o > 0; o >>= 1) {
        const long long u = __shfl_down_sync(FULL, t, o);
        if (lane + o < wl) t = take_max ? (u > t ? u : t) : t + u;
      }
      if (lane == 0) *bc = t;
    }
    __syncthreads();
    xp ^= 1;
    pending = true;
    return *bc;
  }

  // Every slot's decision of a pass, LANES lanes a slot. Every thread of
  // the block calls.
  template <bool KEYS, bool HOME>
  __device__ void decide_all(Slots& s, uint32_t* bins, long long* pts, int NB,
                             bool zero) {
    for (int b0 = 0; b0 < NB; b0 += nt / LANES) {
      const int l = b0 + tid / LANES;
      const bool act = l < NB;
      const int ls = act ? l : 0;
      uint32_t* b = bins + (long long)ls * SLOT_BINS;
      long long* t = pts ? pts + (long long)ls * WAYS : nullptr;
      if (KEYS) {
        key_decide<LANES>(b, s.klo + ls, s.khi + ls, s.below + ls, s.rem[ls],
                          t, act, zero);
      } else {
        water_decide<LANES, HOME>(b, s.lo + ls, s.hi + ls, s.qq[ls], t, act,
                                  zero);
      }
    }
  }

  // The pour's water levels of one spread level in one shot, where the
  // slots are few (the shared route). F_p is piecewise linear between its
  // children's breakpoints k and k + cap, so the largest x in [0, 2^30]
  // with F_p(x) <= q_p is b + (q_p - F_p(b)) / slope, at most 2^30 (2^30
  // where the slope is 0), from the largest breakpoint b <= 2^30 with
  // F_p(b) <= q_p (0 when there is none: F_p(0) = 0): the bisection's
  // answer. A thread a breakpoint sums its parent's children from shared
  // memory (the slots are at most SLOT_SMEM).
  __device__ void exact_levels(Slots& s, int NB) {
    for (int t = tid; t < 2 * NB; t += nt) {
      const int c = t >> 1;
      const int32_t cap = s.cap[c];
      const long long b = (long long)s.kc[c] + ((t & 1) ? cap : 0);
      if (cap <= 0 || b > (1LL << POUR_BITS)) continue;
      const int p = s.par[c];
      long long f = 0;
      for (int d = 0; d < NB; ++d) {
        if (s.par[d] != p) continue;
        const long long x = b - s.kc[d];
        const int32_t cd = s.cap[d];
        f += x <= 0 ? 0 : (x < cd ? x : cd);
      }
      if (f <= s.qq[p])
        atomicMax((unsigned long long*)&s.klo[p], (unsigned long long)b);
    }
    __syncthreads();
    for (int c = tid; c < NB; c += nt) {  // F_p(b) and the slope above b
      const int32_t cap = s.cap[c];
      if (cap <= 0) continue;
      const int p = s.par[c];
      const long long x = s.klo[p] - s.kc[c];
      if (x >= 0 && x < cap) atomicAdd(&s.bnd[p], 1);
      if (x > 0) atomicAdd(&s.cum[p], (int32_t)(x < cap ? x : cap));
    }
    __syncthreads();
    for (int p = tid; p < NB; p += nt) {
      const long long top = 1LL << POUR_BITS;
      const long long lv =
          s.bnd[p] ? s.klo[p] + (s.qq[p] - s.cum[p]) / s.bnd[p] : top;
      s.lo[p] = (int32_t)(lv < top ? lv : top);
    }
  }

  // ---- the pour of one spread level over the branch slots (deciders):
  // exact levels on the shared route, several bits a pass on the global
  __device__ void pour_level(Slots& s, const int32_t* agg, int NB,
                             bool exact) {
    for (int c = tid; c < NB; c += nt) {  // the level's children, once
      const bool valid = __ldcg(agg + 2LL * NB + c) > 0;
      s.vld[c] = valid;
      s.kc[c] = __ldcg(agg + c);
      s.cap[c] = valid ? __ldcg(agg + NB + c) : 0;
      s.par[c] = valid ? __ldcg(agg + 3LL * NB + c) : 0;
      s.capp[c] = 0;
      s.fil[c] = 0;
      s.off[c] = INT32_MAX;
    }
    for (long long e = tid; e < (long long)NB * SLOT_BINS; e += nt)
      s.bins[e] = 0;
    __syncthreads();
    for (int c = tid; c < NB; c += nt)
      if (s.cap[c]) atomicAdd(&s.capp[s.par[c]], s.cap[c]);
    __syncthreads();
    for (int p = tid; p < NB; p += nt) {
      s.qq[p] = s.quota[p] < s.capp[p] ? s.quota[p] : s.capp[p];
      s.lo[p] = 0;
      s.hi[p] = 1 << POUR_BITS;
      s.klo[p] = 0;  // exact levels: the breakpoint, F there, the slope
      s.cum[p] = 0;
      s.bnd[p] = 0;
    }
    __syncthreads();
    if (exact) exact_levels(s, NB);
    for (long long w = (1LL << POUR_BITS) + 1; !exact && w > 1;
         w = ceil_ways(w)) {
      for (int c0 = 0; c0 < NB; c0 += nt) {
        const int c = c0 + tid;
        int32_t cap = 0, k = 0, pp = 0, lo = 0, hi = 0;
        if (c < NB && s.cap[c] > 0) {
          cap = s.cap[c];
          k = s.kc[c];
          pp = s.par[c];
          lo = s.lo[pp];
          hi = s.hi[pp];
        }
        water_add(s.bins, pp, lo, hi, k, cap, cap > 0 && lo < hi);
      }
      __syncthreads();
      decide_all<false, false>(s, s.bins, nullptr, NB, true);
      __syncthreads();
    }
    __syncthreads();
    for (int c = tid; c < NB; c += nt) {  // give, boundary, given
      const bool valid = s.vld[c];
      const int32_t cap = s.cap[c];
      const int32_t k = s.kc[c];
      const int pp = s.par[c];
      const int32_t lvl = s.lo[pp];
      const int32_t d = lvl - k;
      const int32_t gv = valid ? (d <= 0 ? 0 : (d < cap ? d : cap)) : 0;
      s.newq[c] = gv;
      s.bnd[c] = valid && cap > gv && k <= lvl && gv == d;
      if (gv) atomicAdd(&s.fil[pp], gv);
    }
    __syncthreads();
    {  // exclusive cumsum of the boundary flags in child-id order
      const int chunk = (NB + nt - 1) / nt;
      const int s0 = tid * chunk < NB ? tid * chunk : NB;
      const int s1 = s0 + chunk < NB ? s0 + chunk : NB;
      int32_t loc = 0;
      for (int c = s0; c < s1; ++c) loc += s.bnd[c];
      int32_t run = block_excl_scan(loc, sh);
      for (int c = s0; c < s1; ++c) {
        s.cum[c] = run;
        run += s.bnd[c];
      }
    }
    __syncthreads();
    for (int c = tid; c < NB; c += nt)
      atomicMin(&s.off[s.par[c]], s.vld[c] ? s.cum[c] : SEC_PAD);
    __syncthreads();
    for (int c = tid; c < NB; c += nt) {
      if (s.bnd[c]) {
        const int pp = s.par[c];
        if (s.cum[c] - s.off[pp] < s.qq[pp] - s.fil[pp]) s.newq[c] += 1;
      }
    }
    __syncthreads();
    int32_t* t = s.quota;  // this level's child quotas feed the next
    s.quota = s.newq;
    s.newq = t;
  }

  __device__ void run(unsigned char* smem) {
    const int g = pm.g, L = pm.L;
    const long long Np = nd.count();
    const long long per = block_nodes(Np, C);  // this block's node slots
    auto idx_of = [&](long long j) {
      return ((j / CHUNK) * C + rank) * CHUNK + j % CHUNK;
    };

    // ---- the branch bound (K3) and the home, zeroed
    int NB = pm.NB;
    if (NB <= 0) {
      long long m = 0;
      for (long long j = tid; j < per; j += nt) {
        const long long idx = idx_of(j);
        if (idx >= Np) continue;
        const NodeRef r = nd.ref(idx);
        for (int li = 0; li < L; ++li) {
          const long long b =
              r.ranks[((long long)g * L + li) * r.n + r.i] + 1LL;
          m = b > m ? b : m;
        }
      }
      m = cluster_reduce(m, true);
      NB = m > 1 ? (int)m : 1;
    }
    const bool shared_route = NB <= SLOT_SMEM;
    const bool decider = shared_route || rank == 0;
    const int nbuf = home_bufs(NB);
    int32_t* agg = pm.scratch;                           // [L][4][NB]
    uint32_t* gfil = (uint32_t*)(agg + 4LL * L * NB);    // [NB]
    uint32_t* hbins = gfil + NB + 1;                     // [nbuf][NB][48]
    const long long hw = home_words(NB, L);
    const long long hbin_words = (long long)NB * SLOT_BINS;
    for (long long e = (long long)rank * nt + tid; e < hw;
         e += (long long)C * nt)
      pm.scratch[e] = (e < 4LL * L * NB && (e / NB) % 4 == 3) ? INT32_MAX : 0;
    sync_all();

    // the slot state; on the shared route the point tables, and the pour's
    // bins as the block's private sums (branch aggregates, then the leaf
    // passes' bins), flushed into the home
    Slots s = shared_route
                  ? slots_at((int32_t*)smem, nullptr, NB)
                  : slots_at(pm.scratch + hw, pm.scratch64, NB);
    long long* pts = shared_route ? (long long*)(smem + PTS_OFFSET) : nullptr;
    uint32_t* pbins = shared_route ? s.bins : nullptr;
    const long long agg_words = 4LL * L * NB;
    int32_t* pagg =
        pbins && agg_words <= hbin_words ? (int32_t*)pbins : nullptr;
    if (pagg) {
      for (long long e = tid; e < agg_words; e += nt)
        pagg[e] = (e / NB) % 4 == 3 ? INT32_MAX : 0;
      __syncthreads();
    }
    int32_t* tagg = pagg ? pagg : agg;

    // ---- each node's capacity and key, the branch aggregates
    int32_t* nbase = pm.gnode ? pm.gnode + (long long)rank * NODE_I32 * per
                              : (int32_t*)(smem + NODE_OFFSET);
    int32_t* ncap = nbase;
    int32_t* nk = nbase + per;
    int32_t* nleaf = nbase + 2 * per;
    int32_t* nsec = nbase + 3 * per;
    const int32_t svc_row = nd.svc_row(g);
    long long local = 0;
    for (long long base = 0; base < per; base += nt) {
      const long long j = base + tid;
      const long long idx = idx_of(j);
      const bool act = j < per && idx < Np;
      NodeRef r{};
      int32_t sv = 0, cap = 0;
      if (act) {
        r = nd.ref(idx);
        sv = r.s.svc_counts[(long long)svc_row * r.n + r.i];
        cap = node_cap(r.a, r.s, g, r.i, r.n, pm.R, pm.PV, sv);
        ncap[j] = cap;
        nk[j] = (r.a.penalty[(long long)g * r.n + r.i] ? PENALTY_BASE : 0) +
                sv;
        local += cap;
      }
      const int32_t* rk =
          act ? r.ranks + (long long)g * L * r.n + r.i : nullptr;
      int32_t seg = act && L ? rk[0] : 0, pseg = 0;
      for (int li = 0; li < L; ++li) {
        // the next level's id is loaded before this level's sums
        const int32_t next = act && li + 1 < L ? rk[(li + 1LL) * r.n] : 0;
        const int key = act ? seg : -1;
        int32_t* a = tagg + 4LL * li * NB;
        const unsigned peers = __match_any_sync(FULL, key);
        const uint32_t s_sv = __reduce_add_sync(peers, (uint32_t)sv);
        const uint32_t s_cap = __reduce_add_sync(peers, (uint32_t)cap);
        const int32_t pmin = __reduce_min_sync(peers, pseg);
        if (key >= 0 && __ffs(peers) - 1 == (tid & 31)) {
          if (s_sv) atomicAdd(a + key, (int32_t)s_sv);
          if (s_cap) atomicAdd(a + NB + key, (int32_t)s_cap);
          atomicAdd(a + 2LL * NB + key, (int32_t)__popc(peers));
          atomicMin(a + 3LL * NB + key, pmin);
        }
        pseg = seg;
        seg = next;
      }
      if (act) nleaf[j] = L ? pseg : 0;
    }
    if (pagg) {  // the block's aggregates into the home
      __syncthreads();
      for (long long e = tid; e < agg_words; e += nt) {
        const int32_t v = pagg[e];
        if ((e / NB) % 4 == 3) {
          if (v != INT32_MAX) atomicMin(agg + e, v);
        } else if (v) {
          atomicAdd(agg + e, v);
        }
      }
    }
    const long long capsum64 = cluster_reduce(local, false);
    if (capsum64 >= I32_LIMIT) {  // cluster-uniform: refuse the group
      if (rank == 0 && tid == 0) pm.flags[g] = 1;
      for (long long j = tid; j < per; j += nt) {
        const long long idx = idx_of(j);
        if (idx >= Np) continue;
        const NodeRef r = nd.ref(idx);
        r.out[(long long)g * r.n + r.i] = 0;
      }
      if (pending && C > 1) sync_all();
      return;
    }
    if (rank == 0 && tid == 0) pm.flags[g] = 0;
    const int32_t capsum = (int32_t)capsum64;  // < 2^31

    // ---- the pour down the branch levels, on the slots (deciders)
    if (decider) {
      const int32_t nt0 = nd.n_tasks(g);
      const int32_t q0 = nt0 < capsum ? nt0 : capsum;  // one root segment
      for (int p = tid; p < NB; p += nt) s.quota[p] = p == 0 ? q0 : 0;
      __syncthreads();
      for (int li = 0; li < L; ++li)
        pour_level(s, agg + 4LL * li * NB, NB, shared_route);
      const int32_t* lcc = L ? agg + 4LL * (L - 1) * NB + NB : nullptr;
      for (int l = tid; l < NB; l += nt) {
        const int32_t capl = L ? __ldcg(lcc + l) : (l == 0 ? capsum : 0);
        s.qq[l] = s.quota[l] < capl ? s.quota[l] : capl;
        s.lo[l] = 0;
        s.hi[l] = 1 << POUR_BITS;
        if (pts) fill_points(pts + (long long)l * WAYS, 0, 1 << POUR_BITS);
      }
      if (pbins)
        for (long long e = tid; e < hbin_words; e += nt) pbins[e] = 0;
    }
    if (shared_route) {
      __syncthreads();
    } else {
      sync_all();
    }

    // ---- the leaves' water levels, several bits a pass
    long long pass = 0;
    auto buffer = [&](long long p) {
      return hbins + (nbuf == 3 ? p % 3 : 0) * hbin_words;
    };
    auto settle = [&](long long p, bool keys) {
      sync_all();
      uint32_t* hb = buffer(p);
      if (decider) {
        if (keys) {
          decide_all<true, true>(s, hb, pts, NB, !shared_route);
        } else {
          decide_all<false, true>(s, hb, pts, NB, !shared_route);
        }
      }
      if (shared_route) {  // zero the buffer two passes ahead, a share each
        uint32_t* z = buffer(p + 2);
        for (long long e = (long long)rank * nt + tid; e < hbin_words;
             e += (long long)C * nt)
          z[e] = 0;
        __syncthreads();
      } else {
        sync_all();
      }
    };
    auto flush = [&](uint32_t* hb) {  // the block's bins into the home
      if (!pbins) return;
      __syncthreads();
      for (long long e = tid; e < hbin_words; e += nt) {
        const uint32_t v = pbins[e];
        if (v) {
          atomicAdd(hb + e, v);
          pbins[e] = 0;
        }
      }
    };
    for (long long w = (1LL << POUR_BITS) + 1; w > 1;
         w = ceil_ways(w), ++pass) {
      uint32_t* hb = buffer(pass);
      uint32_t* tb = pbins ? pbins : hb;
      for (long long base = 0; base < per; base += nt) {
        const long long j = base + tid;
        int32_t cap = 0, k = 0, lf = 0, lo = 0, hi = 0;
        if (j < per && idx_of(j) < Np) {
          cap = ncap[j];
          lf = nleaf[j];
          k = nk[j];
          lo = s.lo[lf];
          hi = s.hi[lf];
        }
        water_add(tb, lf, lo, hi, k, cap, cap > 0 && lo < hi,
                  pts ? pts + (long long)lf * WAYS : nullptr);
      }
      flush(hb);
      settle(pass, false);
    }

    // ---- base counts, boundary nodes, given sums
    long long kmax = 0;
    for (long long base = 0; base < per; base += nt) {
      const long long j = base + tid;
      const long long idx = idx_of(j);
      int key = -1;
      int32_t c = 0;
      if (j < per && idx < Np) {
        const int32_t cap = ncap[j], k = nk[j], lf = nleaf[j];
        const int32_t lvl = s.lo[lf];
        const int32_t d = lvl - k;
        c = d <= 0 ? 0 : (d < cap ? d : cap);
        const NodeRef r = nd.ref(idx);
        r.out[(long long)g * r.n + r.i] = c;
        int32_t sec = NOT_BOUNDARY;
        if (cap > c && k <= lvl && c == d) {
          sec = r.s.totals[r.i] + c;
          const long long key64 = (long long)sec * Np + idx;
          kmax = key64 > kmax ? key64 : kmax;
        }
        nsec[j] = sec;
        if (c) key = lf;
      }
      agg_add1(gfil, key, (uint32_t)c, 1);
    }
    kmax = cluster_reduce(kmax, true);  // its barrier publishes gfil
    if (decider) {
      int more = 0;
      for (int l = tid; l < NB; l += nt) {
        const int32_t r = s.qq[l] - (int32_t)__ldcg(gfil + l);
        s.rem[l] = r;
        s.klo[l] = 0;
        s.khi[l] = kmax;
        s.below[l] = 0;
        if (pts) fill_points(pts + (long long)l * WAYS, 0, kmax);
        more |= r > 0;
      }
      more = __syncthreads_or(more);
      if (tid == 0) *s.any = more;
    }
    if (shared_route) {
      __syncthreads();
    } else {
      sync_all();
    }

    // ---- the leaf remainders: the rem-th smallest key, several bits a pass
    if (*s.any) {
      for (long long w = kmax + 1; w > 1; w = ceil_ways(w), ++pass) {
        uint32_t* hb = buffer(pass);
        uint32_t* tb = pbins ? pbins : hb;
        for (long long base = 0; base < per; base += nt) {
          const long long j = base + tid;
          const long long idx = idx_of(j);
          int key = -1;
          if (j < per && idx < Np) {
            const int32_t sec = nsec[j];
            if (sec != NOT_BOUNDARY) {
              const int32_t lf = nleaf[j];
              const long long lo = s.klo[lf], hi = s.khi[lf];
              const long long x = (long long)sec * Np + idx;
              if (s.rem[lf] > 0 && lo < hi && x >= lo && x <= hi) {
                const int jx = first_above_at(
                    pts ? pts + (long long)lf * WAYS : nullptr, lo,
                    hi - lo + 1, x);
                if (jx < WAYS) key = lf * WAYS + jx;
              }
            }
          }
          agg_add1(tb, key, 1u, BIN);
        }
        flush(hb);
        settle(pass, true);
      }
    }

    // ---- final counts and the fold
    if (pending && C > 1) sync_all();
    for (long long j = tid; j < per; j += nt) {
      const long long idx = idx_of(j);
      if (idx >= Np) continue;
      const NodeRef r = nd.ref(idx);
      int32_t* o = r.out + (long long)g * r.n + r.i;
      int32_t c = *o;
      const int32_t sec = nsec[j];
      if (sec != NOT_BOUNDARY) {
        const int32_t lf = nleaf[j];
        if (s.rem[lf] > 0 && (long long)sec * Np + idx <= s.klo[lf]) c += 1;
      }
      *o = c;
      fold_node(r.a, r.s, g, r.i, r.n, pm.R, pm.PV, svc_row, c);
    }
  }
};

template <class Nodes>
__global__ void __launch_bounds__(THREADS, 1)
fill_kernel(Nodes nd, Params pm) {
  extern __shared__ __align__(16) unsigned char wf_smem[];
  __shared__ long long red[32];
  __shared__ int32_t sh[32];
  __shared__ long long xch[2];
  __shared__ long long bc;
  Step<Nodes> st{nd,  pm,         red, sh, xch, &bc, (int)gridDim.x,
                 (int)blockIdx.x, (int)threadIdx.x, (int)blockDim.x, 0,
                 false};
  st.run(wf_smem);
}

// ------------------------------------------------------------ the host
struct Launch {
  int cmax;       // the largest cluster the card runs for the kernel
  int smem_max;   // dynamic shared memory a block may take
  cudaError_t err;
};

// For one kernel on the current device: allow the shared memory and a
// non-portable cluster, and find the largest cluster (16, 8, ... 1) that
// cudaOccupancyMaxActiveClusters places at the most shared memory.
inline Launch kernel_limits(const void* kern) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa = {};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
  const int smem_max = optin - (int)fa.sharedSizeBytes;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return Launch{0, 0, err};
  int cmax = 1;
  for (int c = MAX_CLUSTER; c > 1; c >>= 1) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = c;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem_max;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) == cudaSuccess &&
        n >= 1) {
      cmax = c;
      break;
    }
    cudaGetLastError();  // a refused size is not an error of the step
  }
  return Launch{cmax, smem_max, cudaSuccess};
}

// kernel_limits of K, once per device (a function-local cache of each
// instantiation: a library instantiates it over a type of its own).
template <class K>
inline Launch cached_limits(K* kern) {
  static Launch cache[64];
  static bool done[64];
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return Launch{0, 0, err};
  if (dev >= 0 && dev < 64 && done[dev]) return cache[dev];
  const Launch l = kernel_limits((const void*)kern);
  if (l.err == cudaSuccess && dev >= 0 && dev < 64) {
    cache[dev] = l;
    done[dev] = true;
  }
  return l;
}

template <class Nodes>
inline Launch launch_limits() {
  return cached_limits(fill_kernel<Nodes>);
}

// Launch `kern` on one cluster of C blocks of THREADS threads; returns the
// CUDA error that refused it.
template <class... E, class... A>
inline int launch_cluster(void (*kern)(E...), int C, int smem,
                          cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The cluster size for Np nodes: about NODES_PER_BLOCK a block, a power of
// two up to the card's largest.
inline int cluster_for(long long Np, int cmax) {
  int c = 1;
  while (c < cmax && (long long)c * NODES_PER_BLOCK < Np) c <<= 1;
  return c;
}

// How a step over Np nodes with NB branch slots launches: the cluster
// size, the dynamic shared memory, whether the nodes' arrays sit in shared
// memory, whether the slot state does (the shared route).
struct Plan {
  int C, smem, node_smem, shared_route;
};

template <class Nodes>
inline cudaError_t plan_step(long long Np, long long NB, Plan* p) {
  const Launch lim = launch_limits<Nodes>();
  if (lim.err != cudaSuccess) return lim.err;
  p->C = cluster_for(Np, lim.cmax);
  const long long node_bytes = block_nodes(Np, p->C) * NODE_I32 * 4;
  p->node_smem = (long long)NODE_OFFSET + node_bytes <= lim.smem_max;
  p->smem = (int)NODE_OFFSET + (p->node_smem ? (int)node_bytes : 0);
  p->shared_route = NB <= SLOT_SMEM;
  return cudaSuccess;
}

// Launch one step over Np nodes; returns the CUDA error that refused it.
// `gnode` must hold node_words(Np) int32: the nodes go there when a
// block's share does not fit in shared memory.
template <class Nodes>
inline int launch_step(const Nodes& nd, Params pm, long long Np,
                       cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan_step<Nodes>(Np, pm.NB, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.node_smem) pm.gnode = nullptr;
  return launch_cluster(fill_kernel<Nodes>, p.C, p.smem, stream, nd, pm);
}

// The plan as four ints (C, smem, node_smem, shared_route) for a caller.
template <class Nodes>
inline int plan_ints(long long Np, long long NB, int* out) {
  Plan p;
  const cudaError_t err = plan_step<Nodes>(Np, NB, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.C;
  out[1] = p.smem;
  out[2] = p.node_smem;
  out[3] = p.shared_route;
  return 0;
}

}  // namespace wf
}  // namespace skt
