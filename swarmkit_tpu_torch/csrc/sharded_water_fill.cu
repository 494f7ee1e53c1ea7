// K20 sharded_water_fill_step: one group's spread step of the placement
// scan over k node shards on one card (the one-shot mesh path).
//
// Replaces: the sharded forms of swarmkit_tpu/ops/placement.py
// `_flat_water_fill` (:173), `_tree_water_fill` (:209) and
// `_segmented_pour` (:132) inside the `_schedule_core` step (:336-374), as
// swarmkit_tpu/parallel/mesh.py's fused step (`_fused_step` :276,
// `sharded_schedule` :213, `sharded_cluster_step` :224) runs them with the
// node axis sharded and XLA inserting the cross-shard psums.
//
// Bound on this card: the step reads and writes a few tens of bytes per
// node (about 80 at R = 2, PV = 4, plus 4 * LMAX of branch ids): ~11 MB at
// 131,072 nodes, 3 us of memory time. What bounds the kernel is latency: a
// chain of dependent cross-shard reductions, each a grid barrier, 31 per
// bisection and two bisections per spread level.
//
// Design: K3's algorithm (csrc/tree_fill.cu) with each block-wide
// reduction a cross-shard psum (mesh.cuh). One block a shard, launched
// cooperatively. A block computes its shard's capacities and keys and folds
// its shard's state; the branch aggregates (service and capacity sums, node
// counts, the parent's minimum) are sums over every shard, so each shard
// adds into one global branch array with integer atomics and the grid
// barrier completes the sum. Branch ids are global (< N padded): a branch
// may span shards, as in the reference's example clusters. The branch-level
// pour runs on those replicated aggregates; each branch slot belongs to one
// block (a contiguous range of slots a block), so the per-parent bisections
// and the exclusive cumsum of boundary flags in child-id order (a
// cross-shard exclusive scan of the blocks' counts) are each done once.
// L = 0 is the flat fill: one root leaf, every node in branch 0. The leaf
// remainder is the `rem` smallest keys sec * N_padded + global index
// (distinct, int64), found by a per-leaf bisection on counts: the
// multiplier is the padded count, so phantom pad nodes keep keys distinct
// and the order is the reference's lexsort (leaf, sec, index). Phantom
// nodes (ready = False, spread rank 0, no capacity) join branch 0 and
// change no pour, as in the reference (mesh.py:66-67).
//
// Branch slots: n_branches (NB) is one past the largest branch id of the
// problem (1 when L = 0); branches from there to N padded are empty in the
// reference and change nothing. The caller checks every id is below NB.
//
// int32 intermediates and their bounds (capsum = the group's capacity sum
// over all shards, taken in 64 bits and refused from 2^31, so every bound
// below fits):
//   cap_s, c, gv                 <= min(cap, n_tasks) of one node
//   cc, capp, qq, quota, newq,
//   fil, off (a leaf's rem)      <= capsum (sums over a branch's nodes)
//   lo, hi, mid, lvl             in [0, 2^30] (the bisections' range)
//   kc (a branch's service
//   count), k_s = PENALTY_BASE
//   + svc                        the service's tasks already placed, plus
//                                2^20, as in the reference
//   cnt, cum, par                <= N padded (< 2^31, checked by the caller)
//   the leaf remainder keys      int64 ((totals + c) * N_padded + index)
#include "mesh.cuh"

namespace skt {

constexpr int SWF_BRANCH_I32 = 14;  // int32 branch arrays of NB each
constexpr int SWF_NODE_I32 = 3;     // int32 node arrays of N padded each

__global__ void __launch_bounds__(FILL_THREADS, 1)
sharded_water_fill_kernel(GroupSide gs, const ShardRow* rows, int g, int n,
                          int R, int PV, int L, int NB, int32_t* flags,
                          int32_t* node_sc, int32_t* br, long long* br64,
                          long long* xch) {
  __shared__ long long red64[32];
  __shared__ int32_t scan_sh[32];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x, k = gridDim.x;
  const int Np = k * n;                 // nodes over all shards, padded
  const long long base = (long long)b * n;  // this shard's first index
  const ShardRow row = rows[b];
  const GroupArgs a = shard_group_args(gs, row);
  const NodeState s = shard_state(row);
  Exchange x{xch, 0};

  int32_t* cap_s = node_sc + base;            // per node: capacity
  int32_t* k_s = node_sc + Np + base;         // per node: penalty + svc
  int32_t* nbnd = node_sc + 2LL * Np + base;  // per node: boundary flag
  int32_t* quota = br;                        // per branch of level above
  int32_t* newq = br + 1LL * NB;              // per branch of this level
  int32_t* kc = br + 2LL * NB;                // per child: service sum
  int32_t* cc = br + 3LL * NB;                // per child: capacity sum
  int32_t* cnt = br + 4LL * NB;               // per child: node count
  int32_t* par = br + 5LL * NB;               // per child: parent id
  int32_t* capp = br + 6LL * NB;              // per parent: capacity sum
  int32_t* qq = br + 7LL * NB;                // per parent: min(quota, cap)
  int32_t* lo = br + 8LL * NB;                // per parent: bisect low
  int32_t* hi = br + 9LL * NB;                // per parent: bisect high
  int32_t* fil = br + 10LL * NB;              // per parent: filled / given
  int32_t* bnd = br + 11LL * NB;              // per child: boundary flag
  int32_t* cum = br + 12LL * NB;              // per child: excl. cumsum
  int32_t* off = br + 13LL * NB;              // per parent: min cum / rem
  long long* klo = br64;                      // per leaf: key bisection
  long long* khi = br64 + NB;

  // the branch slots this block owns: [c0, c1)
  const int per_block = (NB + k - 1) / k;
  const int c0 = min(b * per_block, NB);
  const int c1 = min(c0 + per_block, NB);

  const int32_t svc_row = a.svc_idx[g];
  const int32_t* svc = s.svc_counts + (int64_t)svc_row * n;
  const int32_t* ranks = row.spread_rank + (int64_t)g * L * n;
  int32_t* out = row.out + (int64_t)g * n;

  // phase 1: the shard's capacities and keys; the capacity sum in 64 bits
  long long local = 0;
  for (int i = tid; i < n; i += nt) {
    const int32_t sv = svc[i];
    const int32_t cap = node_cap(a, s, g, i, n, R, PV, sv);
    cap_s[i] = cap;
    k_s[i] = (a.penalty[(int64_t)g * n + i] ? PENALTY_BASE : 0) + sv;
    local += cap;
  }
  for (int c = c0 + tid; c < c1; c += nt) quota[c] = 0;
  const long long capsum64 = grid_sum(local, red64, x, grid);
  const bool over = capsum64 >= I32_LIMIT;  // grid-uniform
  if (b == 0 && tid == 0) flags[g] = over ? 1 : 0;
  if (over) {
    for (int i = tid; i < n; i += nt) out[i] = 0;
    return;
  }
  const int32_t capsum = (int32_t)capsum64;  // < 2^31
  if (b == 0 && tid == 0) {
    const int32_t ntasks = a.n_tasks[g];
    quota[0] = ntasks < capsum ? ntasks : capsum;  // one root segment
  }
  // the next grid barrier publishes quota[0]

  // ---- branch levels: pour the root quota down the prefix tree ----------
  for (int li = 0; li < L; ++li) {
    const int32_t* seg = ranks + (int64_t)li * n;
    const int32_t* pseg = li ? ranks + (int64_t)(li - 1) * n : nullptr;
    for (int c = c0 + tid; c < c1; c += nt) {
      kc[c] = 0;
      cc[c] = 0;
      cnt[c] = 0;
      par[c] = INT32_MAX;  // segment_min identity
      capp[c] = 0;
      fil[c] = 0;
      off[c] = INT32_MAX;
    }
    grid.sync();
    for (int i = tid; i < n; i += nt) {  // child aggregates: the psums
      const int sg = seg[i];
      atomicAdd(&kc[sg], svc[i]);
      if (cap_s[i]) atomicAdd(&cc[sg], cap_s[i]);
      atomicAdd(&cnt[sg], 1);
      atomicMin(&par[sg], pseg ? pseg[i] : 0);
    }
    grid.sync();
    for (int c = c0 + tid; c < c1; c += nt) {
      if (cnt[c] == 0) {  // empty child: parent 0, no capacity
        par[c] = 0;
        cc[c] = 0;
      }
      if (cc[c]) atomicAdd(&capp[par[c]], cc[c]);
    }
    grid.sync();
    for (int p = c0 + tid; p < c1; p += nt) {
      qq[p] = quota[p] < capp[p] ? quota[p] : capp[p];
      lo[p] = 0;
      hi[p] = 1 << POUR_BITS;
    }
    grid.sync();
    for (int step = 0; step <= POUR_BITS; ++step) {
      for (int c = c0 + tid; c < c1; c += nt) {
        const int32_t cap = cc[c];
        if (cap > 0) {
          const int pp = par[c];
          const int32_t mid = lo[pp] + (hi[pp] - lo[pp] + 1) / 2;
          const int32_t d = mid - kc[c];
          const int32_t f = d <= 0 ? 0 : (d < cap ? d : cap);
          if (f) atomicAdd(&fil[pp], f);
        }
      }
      grid.sync();
      for (int p = c0 + tid; p < c1; p += nt) {
        const int32_t mid = lo[p] + (hi[p] - lo[p] + 1) / 2;
        if (fil[p] <= qq[p]) {
          lo[p] = mid;
        } else {
          hi[p] = mid - 1;
        }
        fil[p] = 0;
      }
      grid.sync();
    }
    for (int c = c0 + tid; c < c1; c += nt) {  // give, boundary, given
      const int pp = par[c];
      const int32_t lvl = lo[pp];
      const int32_t d = lvl - kc[c];
      const int32_t cap = cc[c];
      const bool valid = cnt[c] > 0;
      const int32_t gv = valid ? (d <= 0 ? 0 : (d < cap ? d : cap)) : 0;
      newq[c] = gv;
      bnd[c] = valid && cap > gv && kc[c] <= lvl && gv == d;
      if (gv) atomicAdd(&fil[pp], gv);
    }
    __syncthreads();
    {  // exclusive cumsum of boundary flags in child-id order, all shards
      const int len = c1 - c0;
      const int chunk = (len + nt - 1) / nt;
      const int s0 = c0 + min(tid * chunk, len);
      const int s1 = c0 + min(tid * chunk + chunk, len);
      int32_t loc = 0;
      for (int c = s0; c < s1; ++c) loc += bnd[c];
      int32_t total;
      int32_t run = block_excl_scan(loc, scan_sh, &total);
      run += (int32_t)grid_excl_prefix(total, x, grid);
      for (int c = s0; c < s1; ++c) {
        cum[c] = run;
        run += bnd[c];
      }
    }
    __syncthreads();
    for (int c = c0 + tid; c < c1; c += nt)
      atomicMin(&off[par[c]], cnt[c] > 0 ? cum[c] : SEC_PAD);
    grid.sync();
    for (int c = c0 + tid; c < c1; c += nt) {
      if (bnd[c]) {
        const int pp = par[c];
        if (cum[c] - off[pp] < qq[pp] - fil[pp]) newq[c] += 1;
      }
    }
    grid.sync();
    int32_t* t = quota;  // this level's child quotas feed the next level
    quota = newq;
    newq = t;
  }

  // ---- node level: fill within each leaf branch --------------------------
  const int32_t* leaf = L ? ranks + (int64_t)(L - 1) * n : nullptr;
  for (int l = c0 + tid; l < c1; l += nt) {
    capp[l] = 0;
    fil[l] = 0;
  }
  grid.sync();
  for (int i = tid; i < n; i += nt)
    if (cap_s[i]) atomicAdd(&capp[leaf ? leaf[i] : 0], cap_s[i]);
  grid.sync();
  for (int l = c0 + tid; l < c1; l += nt) {
    qq[l] = quota[l] < capp[l] ? quota[l] : capp[l];
    lo[l] = 0;
    hi[l] = 1 << POUR_BITS;
  }
  grid.sync();
  for (int step = 0; step <= POUR_BITS; ++step) {
    for (int i = tid; i < n; i += nt) {
      const int32_t cap = cap_s[i];
      if (cap > 0) {
        const int lf = leaf ? leaf[i] : 0;
        const int32_t mid = lo[lf] + (hi[lf] - lo[lf] + 1) / 2;
        const int32_t d = mid - k_s[i];
        const int32_t f = d <= 0 ? 0 : (d < cap ? d : cap);
        if (f) atomicAdd(&fil[lf], f);
      }
    }
    grid.sync();
    for (int l = c0 + tid; l < c1; l += nt) {
      const int32_t mid = lo[l] + (hi[l] - lo[l] + 1) / 2;
      if (fil[l] <= qq[l]) {
        lo[l] = mid;
      } else {
        hi[l] = mid - 1;
      }
      fil[l] = 0;
    }
    grid.sync();
  }
  long long kmax = 0;
  for (int i = tid; i < n; i += nt) {  // base counts and boundary nodes
    const int lf = leaf ? leaf[i] : 0;
    const int32_t lvl = lo[lf];
    const int32_t d = lvl - k_s[i];
    const int32_t cap = cap_s[i];
    const int32_t c = d <= 0 ? 0 : (d < cap ? d : cap);
    out[i] = c;
    if (c) atomicAdd(&fil[lf], c);
    const bool bd = cap > c && k_s[i] <= lvl && c == d;
    nbnd[i] = bd;
    if (bd) {
      const long long key = (long long)(s.totals[i] + c) * Np + base + i;
      kmax = key > kmax ? key : kmax;
    }
  }
  kmax = grid_max(kmax, red64, x, grid);  // its barrier completes fil
  long long rmax = 0;
  for (int l = c0 + tid; l < c1; l += nt) {
    const int32_t r = qq[l] - fil[l];
    off[l] = r;
    klo[l] = 0;
    khi[l] = kmax;
    cnt[l] = 0;
    rmax = r > rmax ? r : rmax;
  }
  rmax = grid_max(rmax, red64, x, grid);  // publishes off, klo, khi
  if (rmax > 0) {
    const int steps = 65 - __clzll(kmax | 1);
    for (int it = 0; it < steps; ++it) {
      for (int i = tid; i < n; i += nt) {
        if (nbnd[i]) {
          const int lf = leaf ? leaf[i] : 0;
          if (off[lf] > 0 && klo[lf] < khi[lf]) {
            const long long mid = klo[lf] + (khi[lf] - klo[lf]) / 2;
            const long long key =
                (long long)(s.totals[i] + out[i]) * Np + base + i;
            if (key <= mid) atomicAdd(&cnt[lf], 1);
          }
        }
      }
      grid.sync();
      for (int l = c0 + tid; l < c1; l += nt) {
        if (off[l] > 0 && klo[l] < khi[l]) {
          const long long mid = klo[l] + (khi[l] - klo[l]) / 2;
          if (cnt[l] >= off[l]) {
            khi[l] = mid;
          } else {
            klo[l] = mid + 1;
          }
        }
        cnt[l] = 0;
      }
      grid.sync();
    }
  }
  for (int i = tid; i < n; i += nt) {  // final counts and the shard's fold
    int32_t c = out[i];
    if (nbnd[i]) {
      const int lf = leaf ? leaf[i] : 0;
      if (off[lf] > 0 &&
          (long long)(s.totals[i] + c) * Np + base + i <= klo[lf])
        c += 1;
    }
    out[i] = c;
    fold_node(a, s, g, i, n, R, PV, svc_row, c);
  }
}

}  // namespace skt

extern "C" int skt_sharded_water_fill_scratch(int which) {
  return which == 0 ? skt::SWF_BRANCH_I32 : skt::SWF_NODE_I32;
}

extern "C" int skt_sharded_water_fill_max_shards() {
  return skt::max_coresident((const void*)skt::sharded_water_fill_kernel);
}

extern "C" int skt_sharded_water_fill_step(
    const void* need_res, const void* n_tasks, const void* svc_idx,
    const void* max_replicas, const void* has_ports, const void* group_ports,
    const void* rows, void* flags, void* node_scratch, void* branch_scratch,
    void* branch_scratch64, void* exchange, int g, int k, int n, int R,
    int PV, int L, int NB, void* stream) {
  skt::GroupSide gs{(const int32_t*)need_res, (const int32_t*)n_tasks,
                    (const int32_t*)svc_idx,  (const int32_t*)max_replicas,
                    (const uint8_t*)has_ports, (const uint8_t*)group_ports};
  const skt::ShardRow* r = (const skt::ShardRow*)rows;
  int32_t* fl = (int32_t*)flags;
  int32_t* nsc = (int32_t*)node_scratch;
  int32_t* bsc = (int32_t*)branch_scratch;
  long long* bsc64 = (long long*)branch_scratch64;
  long long* xch = (long long*)exchange;
  void* args[] = {&gs, &r, &g, &n, &R, &PV, &L, &NB, &fl, &nsc, &bsc, &bsc64,
                  &xch};
  return skt::launch_cooperative(
      (const void*)skt::sharded_water_fill_kernel, k, args,
      (cudaStream_t)stream);
}
