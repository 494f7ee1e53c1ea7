// The binpack group step of the placement scan as a cap-weighted radix
// select over one thread block cluster: the body of K9 (binpack_fill.cu,
// one shard of N nodes), written over the node policies of the water-fill
// body (water_fill.cuh `OneShard`, `Shards`) so that a sharded entry can
// take it with a shard policy.
//
// Replaces: swarmkit_tpu/ops/placement.py `_binpack_fill` (:285) inside the
// `_schedule_core` step (:336-374): per-node capacity, a stable lexsort of
// the nodes by (penalty, -svc, -total, node index), the prefix sum of the
// sorted capacities against q = min(n_tasks, sum(cap)), each node's
// clip(q - prefix_before, 0, cap), and the fold of totals / service counts
// / resources / ports. It computes what the plain version computes, bit
// for bit (ops/placement.py `binpack_fill_step_plain`).
//
// Bound on this card: a step reads and writes a few tens of bytes a node
// (~8 MB at 131,072 nodes, 2.5 us of memory time). What bounds it is
// latency: the dependent rounds of a search over the nodes, each a barrier.
//
// Design. No sort. The key is distinct (the node index breaks ties), so in
// key order every node before one boundary node B is full, B takes q -
// base (base: the capacity before B), and every node after B takes 0;
// nodes without capacity take 0 wherever they sit. B is the node of
// smallest key whose inclusive capacity prefix reaches q.
//  * One cluster. The C blocks of one thread block cluster (1, 2, 4, 8 or
//    16 by node count, about NODES_PER_BLOCK a block) are dealt the node
//    range in chunks of 32, round robin (water_fill.cuh `block_nodes`), and
//    keep their nodes' cap, service count, total and penalty in shared
//    memory (device scratch past what fits).
//  * Phase 1 is one cluster reduction: the capacity sum (64 bits) and the
//    key ranges of the nodes with capacity (smax, -smin, tmax, -tmin) in one
//    block reduction of five values, then one exchange through distributed
//    shared memory (DSMEM).
//  * One packed key where it fits: pen | (smax - svc) | (tmax - total) |
//    index, fields of 1, bits(srange), bits(trange) and bits(N - 1) bits,
//    when they total at most 63 (the route is taken from phase 1's values,
//    the same in every block). Above 63 bits the same select runs over the
//    four components in turn (the lexsort's keys, each exact in 64 bits).
//  * A weighted radix select, 8 bits a pass from the top. Each block sums
//    the cap of its candidates (capacity > 0, the higher digits equal to
//    the prefix chosen so far) into 256 private bins, a warp whose
//    candidates share one digit in one atomic. After one cluster barrier
//    every block reads the C x 256 bins over DSMEM, scans them in the same
//    order and takes the digit where base + the running sum reaches q,
//    adding the sum below it to base: every block takes the same decision.
//    The bins alternate between two buffers (the one read last pass is
//    zeroed while this pass's is read), so a pass costs one barrier.
//  * No search when q is 0 or the whole capacity. The last node pass
//    writes the counts and folds (fold_node); the blocks' remote reads are
//    fenced from their exit by a split cluster barrier around it.
//
// Cluster barriers a step (C = 1 turns each into __syncthreads): 1 + the
// key's passes, ceil(bits / 8) (3 on a 20-bit key); the one-block body
// took five block reductions and 25-80 bisection steps, each a barrier and
// a pass over every node.
//
// int32 intermediates: every sum over nodes is bounded by the group's
// capacity sum, taken in 64 bits and refused from 2^31 (flag set, counts
// zeroed, nothing folded); the bins are uint32, base and the running sums
// int64, the key fields unsigned 64-bit from int64 differences.
#pragma once

#include "water_fill.cuh"

namespace skt {
namespace bp {

namespace cg = cooperative_groups;

constexpr int THREADS = wf::THREADS;  // wf::launch_cluster launches these
constexpr int DIGIT_BITS = 8;
constexpr int DIGITS = 1 << DIGIT_BITS;  // bins a pass
constexpr int NODE_BYTES = 13;           // cap, svc, total (int32), penalty
constexpr unsigned FULL = 0xffffffffu;

// int32 words of the device-scratch node arrays for Np nodes, any cluster
// (C blocks hold at most Np + 32 C node slots).
__host__ __device__ constexpr long long node_words(long long Np) {
  return ((Np + (long long)wf::CHUNK * wf::MAX_CLUSTER) * NODE_BYTES + 3) /
         4;
}

struct Params {
  int g, R, PV;
  int32_t* flags;  // [G]
  int32_t* gnode;  // node_words(Np) int32, or null: nodes in shared memory
};

// A block's phase-1 partials, read by every block of the cluster.
struct Part {
  long long capsum;
  int32_t smax, nsmin, tmax, ntmin;
};

struct Smem {
  uint32_t bins[2][DIGITS];  // the pass's private bins, two buffers
  unsigned long long fixed[4];  // B's key, field by field, as chosen so far
  Part part, all;
  long long red64[32];
  int32_t red32[4][32];
  uint32_t wsum[DIGITS / 32];
  long long sel_base;
  int sel_digit;
};

__device__ __forceinline__ int bits_of(unsigned long long x) {
  return x ? 64 - __clzll((long long)x) : 0;
}

// v's bits from bit s up (0 when s >= 64).
__device__ __forceinline__ unsigned long long above(unsigned long long v,
                                                    int s) {
  return s >= 64 ? 0ull : v >> s;
}

__device__ __forceinline__ int32_t imax(int32_t a, int32_t b) {
  return a > b ? a : b;
}

// The binpack key as nf fields in order: one packed word (nf == 1) or the
// four components (pen, smax - svc, tmax - total, index). Nodes without
// capacity may fall outside the ranges; they never enter the select.
struct Key {
  long long smax, tmax;
  int nf;
  int w0, w1, w2, w3;  // bits of each field (w0 the packed width)
  int s0, s1, s2;      // packed: the shifts of pen, svc and total

  __device__ __forceinline__ int width(int f) const {
    return f == 0 ? w0 : (f == 1 ? w1 : (f == 2 ? w2 : w3));
  }
  __device__ __forceinline__ unsigned long long field(int f, int32_t pen,
                                                      int32_t sv, int32_t t,
                                                      long long idx) const {
    const unsigned long long s = (unsigned long long)(smax - sv);
    const unsigned long long u = (unsigned long long)(tmax - t);
    if (nf == 1)
      return ((unsigned long long)pen << s0) | (s << s1) | (u << s2) |
             (unsigned long long)idx;
    switch (f) {
      case 0:
        return (unsigned long long)pen;
      case 1:
        return s;
      case 2:
        return u;
      default:
        return (unsigned long long)idx;
    }
  }
};

// Adds w into bins[d]; every lane of the warp calls, d < 0 adds nothing.
// Where every candidate of the warp has one digit its sum goes in one
// atomic.
__device__ __forceinline__ void warp_add(uint32_t* bins, int d, uint32_t w) {
  const unsigned act = __ballot_sync(FULL, d >= 0);
  if (!act) return;
  const int lead = __ffs(act) - 1;
  const int d0 = __shfl_sync(FULL, d, lead);
  if (__all_sync(FULL, d < 0 || d == d0)) {
    const uint32_t s = __reduce_add_sync(FULL, d >= 0 ? w : 0u);
    if ((int)(threadIdx.x & 31) == lead) atomicAdd(bins + d0, s);
  } else if (d >= 0) {
    atomicAdd(bins + d, w);
  }
}

// Barriers of the cluster split in two: a block arrives when it has made
// its last remote read and waits before it exits, so no block leaves while
// another may still read its shared memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" : : : "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" : : : "memory");
}

// ------------------------------------------------- the step, per block
template <class Nodes>
struct Select {
  Nodes nd;
  Params pm;
  Smem& sm;
  int C, rank, tid, nt;

  __device__ __forceinline__ void sync_all() {
    if (C == 1) {
      __syncthreads();
    } else {
      cg::this_cluster().sync();
    }
  }

  // Phase 1's five values over the cluster into sm.all; every thread
  // calls. The cluster barrier inside publishes the blocks' node arrays
  // and zeroed bins too.
  __device__ void reduce_part(long long cs, int32_t a, int32_t b, int32_t c,
                              int32_t d) {
    const int lane = tid & 31, w = tid >> 5, nw = nt >> 5;
    for (int o = 16; o > 0; o >>= 1) {
      cs += __shfl_down_sync(FULL, cs, o);
      a = imax(a, __shfl_down_sync(FULL, a, o));
      b = imax(b, __shfl_down_sync(FULL, b, o));
      c = imax(c, __shfl_down_sync(FULL, c, o));
      d = imax(d, __shfl_down_sync(FULL, d, o));
    }
    if (lane == 0) {
      sm.red64[w] = cs;
      sm.red32[0][w] = a;
      sm.red32[1][w] = b;
      sm.red32[2][w] = c;
      sm.red32[3][w] = d;
    }
    __syncthreads();
    if (w == 0) {
      const bool in = lane < nw;
      cs = in ? sm.red64[lane] : 0;
      a = in ? sm.red32[0][lane] : INT_MIN;
      b = in ? sm.red32[1][lane] : INT_MIN;
      c = in ? sm.red32[2][lane] : INT_MIN;
      d = in ? sm.red32[3][lane] : INT_MIN;
      for (int o = 16; o > 0; o >>= 1) {
        cs += __shfl_down_sync(FULL, cs, o);
        a = imax(a, __shfl_down_sync(FULL, a, o));
        b = imax(b, __shfl_down_sync(FULL, b, o));
        c = imax(c, __shfl_down_sync(FULL, c, o));
        d = imax(d, __shfl_down_sync(FULL, d, o));
      }
      if (lane == 0) sm.part = Part{cs, a, b, c, d};
    }
    sync_all();
    if (w == 0) {
      Part t{0, INT_MIN, INT_MIN, INT_MIN, INT_MIN};
      for (int r = lane; r < C; r += 32) {
        const Part p =
            C == 1 ? sm.part : *cg::this_cluster().map_shared_rank(&sm.part, r);
        t.capsum += p.capsum;
        t.smax = imax(t.smax, p.smax);
        t.nsmin = imax(t.nsmin, p.nsmin);
        t.tmax = imax(t.tmax, p.tmax);
        t.ntmin = imax(t.ntmin, p.ntmin);
      }
      for (int o = 16; o > 0; o >>= 1) {
        t.capsum += __shfl_down_sync(FULL, t.capsum, o);
        t.smax = imax(t.smax, __shfl_down_sync(FULL, t.smax, o));
        t.nsmin = imax(t.nsmin, __shfl_down_sync(FULL, t.nsmin, o));
        t.tmax = imax(t.tmax, __shfl_down_sync(FULL, t.tmax, o));
        t.ntmin = imax(t.ntmin, __shfl_down_sync(FULL, t.ntmin, o));
      }
      if (lane == 0) sm.all = t;
    }
    __syncthreads();
  }

  // A pass's digit: the cluster's bins of buffer `buf` summed digit by
  // digit, scanned in digit order; the digit where base + the running sum
  // reaches q goes to sm.sel_digit, base + the sum below it to
  // sm.sel_base. Zeroes this block's other buffer (read last pass, written
  // next). Every thread calls, after the barrier that publishes the bins.
  __device__ void decide(int buf, long long base, int32_t q) {
    uint32_t h = 0, x = 0;
    if (tid < DIGITS) {
      if (C == 1) {
        h = sm.bins[buf][tid];
      } else {
        uint32_t v[wf::MAX_CLUSTER];
#pragma unroll
        for (int r = 0; r < wf::MAX_CLUSTER; ++r)
          v[r] = r < C ? cg::this_cluster().map_shared_rank(sm.bins[buf],
                                                            r)[tid]
                       : 0u;
#pragma unroll
        for (int r = 0; r < wf::MAX_CLUSTER; ++r) h += v[r];
      }
      sm.bins[buf ^ 1][tid] = 0;
      x = h;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL, x, o);
        if ((tid & 31) >= o) x += y;
      }
      if ((tid & 31) == 31) sm.wsum[tid >> 5] = x;
    }
    __syncthreads();
    if (tid < DIGITS) {
      long long below = base + (long long)(x - h);
      for (int w = 0; w < (tid >> 5); ++w) below += sm.wsum[w];
      if (below < q && below + h >= q) {
        sm.sel_digit = tid;
        sm.sel_base = below;
      }
    }
    __syncthreads();
  }

  __device__ void run(unsigned char* smem) {
    const int g = pm.g;
    const long long Np = nd.count();
    const long long per = wf::block_nodes(Np, C);  // this block's slots
    auto idx_of = [&](long long j) {
      return ((j / wf::CHUNK) * C + rank) * wf::CHUNK + j % wf::CHUNK;
    };
    unsigned char* nbase =
        pm.gnode ? (unsigned char*)pm.gnode + (long long)rank * per *
                                                  NODE_BYTES
                 : smem;
    int32_t* ncap = (int32_t*)nbase;
    int32_t* nsvc = ncap + per;
    int32_t* ntot = nsvc + per;
    uint8_t* npen = (uint8_t*)(ntot + per);
    for (int e = tid; e < 2 * DIGITS; e += nt) (&sm.bins[0][0])[e] = 0;
    if (tid < 4) sm.fixed[tid] = 0;

    // ---- phase 1: capacities, their sum, the key ranges
    const int32_t svc_row = nd.svc_row(g);
    long long local = 0;
    int32_t smax = INT_MIN, nsmin = INT_MIN, tmax = INT_MIN, ntmin = INT_MIN;
    for (long long j = tid; j < per; j += nt) {
      const long long idx = idx_of(j);
      if (idx >= Np) continue;
      const wf::NodeRef r = nd.ref(idx);
      const int32_t sv = r.s.svc_counts[(long long)svc_row * r.n + r.i];
      const int32_t cap = node_cap(r.a, r.s, g, r.i, r.n, pm.R, pm.PV, sv);
      const int32_t t = r.s.totals[r.i];
      ncap[j] = cap;
      nsvc[j] = sv;
      ntot[j] = t;
      npen[j] = r.a.penalty[(long long)g * r.n + r.i] ? 1 : 0;
      local += cap;
      if (cap > 0) {
        smax = imax(smax, sv);
        nsmin = imax(nsmin, -sv);
        tmax = imax(tmax, t);
        ntmin = imax(ntmin, -t);
      }
    }
    reduce_part(local, smax, nsmin, tmax, ntmin);
    const Part all = sm.all;
    const bool over = all.capsum >= I32_LIMIT;  // cluster-uniform
    if (rank == 0 && tid == 0) pm.flags[g] = over ? 1 : 0;
    const int32_t capsum = (int32_t)all.capsum;  // < 2^31 unless over
    const int32_t ntasks = nd.n_tasks(g);
    const int32_t q = ntasks < capsum ? ntasks : capsum;
    const bool search = !over && q > 0 && q < capsum;

    // ---- B's key, 8 bits a pass (cluster-uniform: every bound comes
    // from phase 1 or a decision every block takes alike)
    Key key{};
    long long base = 0;
    if (search) {
      key.smax = all.smax;
      key.tmax = all.tmax;
      const int bs = bits_of((unsigned long long)((long long)all.smax +
                                                  all.nsmin));
      const int bt = bits_of((unsigned long long)((long long)all.tmax +
                                                  all.ntmin));
      const int bi = bits_of((unsigned long long)(Np - 1));
      const int W = 1 + bs + bt + bi;
      key.nf = W <= 63 ? 1 : 4;
      key.w0 = key.nf == 1 ? W : 1;
      key.w1 = bs;
      key.w2 = bt;
      key.w3 = bi;
      key.s0 = bs + bt + bi;
      key.s1 = bt + bi;
      key.s2 = bi;
      int buf = 0;
      for (int f = 0; f < key.nf; ++f) {
        const int wf_ = key.width(f);
        for (int sh = (wf_ + DIGIT_BITS - 1) / DIGIT_BITS * DIGIT_BITS -
                      DIGIT_BITS;
             sh >= 0; sh -= DIGIT_BITS) {
          const unsigned long long pre = above(sm.fixed[f], sh + DIGIT_BITS);
          for (long long b0 = 0; b0 < per; b0 += nt) {
            const long long j = b0 + tid;
            int d = -1;
            uint32_t w = 0;
            if (j < per) {
              const long long idx = idx_of(j);
              const int32_t cap = idx < Np ? ncap[j] : 0;
              if (cap > 0) {
                const int32_t pen = npen[j], sv = nsvc[j], t = ntot[j];
                bool cand = true;
                for (int e = 0; e < f && cand; ++e)
                  cand = key.field(e, pen, sv, t, idx) == sm.fixed[e];
                const unsigned long long v = key.field(f, pen, sv, t, idx);
                if (cand && above(v, sh + DIGIT_BITS) == pre) {
                  d = (int)((v >> sh) & (DIGITS - 1));
                  w = (uint32_t)cap;
                }
              }
            }
            warp_add(sm.bins[buf], d, w);
          }
          sync_all();
          decide(buf, base, q);
          base = sm.sel_base;
          if (tid == 0)
            sm.fixed[f] |= (unsigned long long)sm.sel_digit << sh;
          __syncthreads();
          buf ^= 1;
        }
      }
    }
    if (C > 1) cluster_arrive();  // this block's last remote read is done

    // ---- counts in key order around B, and the fold
    for (long long j = tid; j < per; j += nt) {
      const long long idx = idx_of(j);
      if (idx >= Np) continue;
      const wf::NodeRef r = nd.ref(idx);
      int32_t* o = r.out + (long long)g * r.n + r.i;
      if (over) {
        *o = 0;
        continue;
      }
      const int32_t cap = ncap[j];
      int32_t c = q >= capsum ? cap : 0;
      if (search && cap > 0) {
        const int32_t pen = npen[j], sv = nsvc[j], t = ntot[j];
        int cmp = 0;
        for (int f = 0; f < key.nf && cmp == 0; ++f) {
          const unsigned long long v = key.field(f, pen, sv, t, idx);
          const unsigned long long b = sm.fixed[f];
          cmp = v < b ? -1 : (v > b ? 1 : 0);
        }
        c = cmp < 0 ? cap : (cmp == 0 ? q - (int32_t)base : 0);
      }
      *o = c;
      fold_node(r.a, r.s, g, r.i, r.n, pm.R, pm.PV, svc_row, c);
    }
    if (C > 1) cluster_wait();
  }
};

template <class Nodes>
__global__ void __launch_bounds__(THREADS, 1)
select_kernel(Nodes nd, Params pm) {
  extern __shared__ __align__(16) unsigned char bp_smem[];
  __shared__ Smem sm;
  Select<Nodes> st{nd, pm, sm, (int)gridDim.x, (int)blockIdx.x,
                   (int)threadIdx.x, (int)blockDim.x};
  st.run(bp_smem);
}

// ------------------------------------------------------------ the host
template <class Nodes>
inline wf::Launch launch_limits() {
  return wf::cached_limits(select_kernel<Nodes>);
}

// How a step over Np nodes launches: the cluster size, the dynamic shared
// memory, whether the nodes' arrays sit in shared memory.
struct Plan {
  int C, smem, node_smem;
};

template <class Nodes>
inline cudaError_t plan_step(long long Np, Plan* p) {
  const wf::Launch lim = launch_limits<Nodes>();
  if (lim.err != cudaSuccess) return lim.err;
  p->C = wf::cluster_for(Np, lim.cmax);
  const long long bytes = wf::block_nodes(Np, p->C) * NODE_BYTES;
  p->node_smem = bytes <= lim.smem_max;
  p->smem = p->node_smem ? (int)bytes : 0;
  return cudaSuccess;
}

// Launch one step over Np nodes; returns the CUDA error that refused it.
// `pm.gnode` must hold node_words(Np) int32: the nodes go there when a
// block's share does not fit in shared memory.
template <class Nodes>
inline int launch_step(const Nodes& nd, Params pm, long long Np,
                       cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan_step<Nodes>(Np, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.node_smem) pm.gnode = nullptr;
  return wf::launch_cluster(select_kernel<Nodes>, p.C, p.smem, stream, nd,
                            pm);
}

// The plan as three ints (C, smem, node_smem) for a caller.
template <class Nodes>
inline int plan_ints(long long Np, int* out) {
  Plan p;
  const cudaError_t err = plan_step<Nodes>(Np, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.C;
  out[1] = p.smem;
  out[2] = p.node_smem;
  return 0;
}

}  // namespace bp
}  // namespace skt
