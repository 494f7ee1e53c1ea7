// K3 tree_fill_step: one group's step of the placement scan when the problem
// has spread levels (LMAX > 0).
//
// Replaces: swarmkit_tpu/ops/placement.py `_schedule_core` step (:336-374)
// with `_tree_water_fill` (:209) and `_segmented_pour` (:132): the quota
// pours down the spread levels (per level: branch sums and mins, a
// per-parent 31-step bisect, and a remainder ranked by an exclusive cumsum
// of boundary flags minus the parent's minimum), then a per-leaf bisect and
// a remainder ranked by (leaf, total + counts, node index), then the fold.
//
// Bound on this card: the step moves a few tens of bytes per node (plus
// 4 * LMAX bytes of branch ids), a few hundred KB at 10k nodes, which is
// well under a microsecond of memory time. What bounds the kernel is
// latency: each bisect step is three dependent passes over N slots with
// global atomics into per-branch sums, 31 steps per level and at the leaf.
//
// Design: one block per group step (the host launches the groups in order),
// __syncthreads between phases, per-branch arrays in global scratch indexed
// by branch id (ids are < N, as the encoder's prefix ranks are). Integer
// atomics make every segment sum exact in any order. The leaf remainder
// needs no sort: with key = sec * N + idx (distinct, int64) the leaf's `rem`
// smallest boundary keys are those <= its rem-th smallest, found by a
// per-leaf bisection on counts.
//
// int32 intermediates and their bounds (capsum = the group's capacity sum,
// taken in 64 bits and refused from 2^31, so every bound below fits):
//   cap_s, c, gv                 <= min(cap, n_tasks) of one node
//   cc, capp, qq, quota, newq,
//   fil, off (a leaf's rem)      <= capsum (sums over a branch's nodes)
//   lo, hi, mid, lvl             in [0, 2^30] (the bisections' range)
//   kc (a branch's service
//   count), k_s = PENALTY_BASE
//   + svc                        the service's tasks already placed, plus
//                                2^20, as in the reference
//   cnt, cum, par                <= N (node counts, flag ranks, branch ids)
//   the leaf remainder keys      int64 ((totals + c) * N + n)
#include "common.cuh"

namespace skt {

constexpr int TREE_I32_ARRAYS = 16;  // int32 scratch arrays of N each

__global__ void __launch_bounds__(FILL_THREADS, 1)
tree_fill_kernel(GroupArgs a, NodeState s, const int32_t* spread_rank, int g,
                 int N, int R, int PV, int L, int32_t* out, int32_t* flags,
                 int32_t* sc, long long* sc64) {
  __shared__ int32_t red32[32];
  __shared__ long long red64[32];
  __shared__ int32_t scan_sh[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  int32_t* cap_s = sc;           // per node: capacity
  int32_t* k_s = sc + 1 * N;     // per node: penalty * B + svc
  int32_t* quota = sc + 2 * N;   // per branch of the level above
  int32_t* newq = sc + 3 * N;    // per branch of this level
  int32_t* kc = sc + 4 * N;      // per child: service-count sum
  int32_t* cc = sc + 5 * N;      // per child: capacity sum (0 if empty)
  int32_t* cnt = sc + 6 * N;     // per child: node count / leaf counter
  int32_t* par = sc + 7 * N;     // per child: parent id
  int32_t* capp = sc + 8 * N;    // per parent: capacity sum
  int32_t* qq = sc + 9 * N;      // per parent: min(quota, capacity)
  int32_t* lo = sc + 10 * N;     // per parent: bisect low
  int32_t* hi = sc + 11 * N;     // per parent: bisect high
  int32_t* fil = sc + 12 * N;    // per parent: filled / given sum
  int32_t* bnd = sc + 13 * N;    // per child / node: boundary flag
  int32_t* cum = sc + 14 * N;    // per child: exclusive cumsum of bnd
  int32_t* off = sc + 15 * N;    // per parent: min cum; per leaf: rem
  long long* klo = sc64;         // per leaf: remainder key bisect
  long long* khi = sc64 + N;

  const int32_t svc_row = a.svc_idx[g];
  const int32_t* svc = s.svc_counts + (int64_t)svc_row * N;
  const int32_t* ranks = spread_rank + (int64_t)g * L * N;

  long long local = 0;  // the capacity sum, in 64 bits
  for (int n = tid; n < N; n += nt) {
    const int32_t sv = svc[n];
    const int32_t cap = node_cap(a, s, g, n, N, R, PV, sv);
    cap_s[n] = cap;
    k_s[n] = (a.penalty[(int64_t)g * N + n] ? PENALTY_BASE : 0) + sv;
    local += cap;
    quota[n] = 0;
  }
  const long long capsum64 = block_sum(local, red64);
  if (refuse_overflow(capsum64, flags, g, out + (int64_t)g * N, N)) return;
  const int32_t capsum = (int32_t)capsum64;  // < 2^31
  if (tid == 0) {
    const int32_t ntasks = a.n_tasks[g];
    quota[0] = ntasks < capsum ? ntasks : capsum;  // a single root segment
  }
  __syncthreads();

  // ---- branch levels: pour the root quota down the prefix tree ----------
  for (int li = 0; li < L; ++li) {
    const int32_t* seg = ranks + (int64_t)li * N;
    const int32_t* pseg = li ? ranks + (int64_t)(li - 1) * N : nullptr;
    for (int c = tid; c < N; c += nt) {
      kc[c] = 0;
      cc[c] = 0;
      cnt[c] = 0;
      par[c] = INT32_MAX;  // segment_min identity
      capp[c] = 0;
      fil[c] = 0;
      off[c] = INT32_MAX;
    }
    __syncthreads();
    for (int n = tid; n < N; n += nt) {  // child aggregates
      const int sg = seg[n];
      atomicAdd(&kc[sg], svc[n]);
      if (cap_s[n]) atomicAdd(&cc[sg], cap_s[n]);
      atomicAdd(&cnt[sg], 1);
      atomicMin(&par[sg], pseg ? pseg[n] : 0);
    }
    __syncthreads();
    for (int c = tid; c < N; c += nt) {
      if (cnt[c] == 0) {  // empty child: parent 0, no capacity
        par[c] = 0;
        cc[c] = 0;
      }
    }
    __syncthreads();
    for (int c = tid; c < N; c += nt)
      if (cc[c]) atomicAdd(&capp[par[c]], cc[c]);
    __syncthreads();
    for (int p = tid; p < N; p += nt) {
      qq[p] = quota[p] < capp[p] ? quota[p] : capp[p];
      lo[p] = 0;
      hi[p] = 1 << POUR_BITS;
    }
    __syncthreads();
    for (int step = 0; step <= POUR_BITS; ++step) {
      for (int c = tid; c < N; c += nt) {
        const int32_t cap = cc[c];
        if (cap > 0) {
          const int pp = par[c];
          const int32_t mid = lo[pp] + (hi[pp] - lo[pp] + 1) / 2;
          const int32_t d = mid - kc[c];
          const int32_t f = d <= 0 ? 0 : (d < cap ? d : cap);
          if (f) atomicAdd(&fil[pp], f);
        }
      }
      __syncthreads();
      for (int p = tid; p < N; p += nt) {
        const int32_t mid = lo[p] + (hi[p] - lo[p] + 1) / 2;
        if (fil[p] <= qq[p]) {
          lo[p] = mid;
        } else {
          hi[p] = mid - 1;
        }
        fil[p] = 0;
      }
      __syncthreads();
    }
    for (int c = tid; c < N; c += nt) {  // give, boundary, given per parent
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
    {  // exclusive cumsum of boundary flags in child-id order
      const int chunk = (N + nt - 1) / nt;
      const int c0 = tid * chunk < N ? tid * chunk : N;
      const int c1 = c0 + chunk < N ? c0 + chunk : N;
      int32_t loc = 0;
      for (int c = c0; c < c1; ++c) loc += bnd[c];
      int32_t total;
      int32_t base = block_excl_scan(loc, scan_sh, &total);
      for (int c = c0; c < c1; ++c) {
        cum[c] = base;
        base += bnd[c];
      }
    }
    __syncthreads();
    for (int c = tid; c < N; c += nt)
      atomicMin(&off[par[c]], cnt[c] > 0 ? cum[c] : SEC_PAD);
    __syncthreads();
    for (int c = tid; c < N; c += nt) {
      if (bnd[c]) {
        const int pp = par[c];
        if (cum[c] - off[pp] < qq[pp] - fil[pp]) newq[c] += 1;
      }
    }
    __syncthreads();
    int32_t* t = quota;  // this level's child quotas feed the next level
    quota = newq;
    newq = t;
  }

  // ---- node level: fill within each leaf branch --------------------------
  const int32_t* leaf = ranks + (int64_t)(L - 1) * N;
  for (int l = tid; l < N; l += nt) {
    capp[l] = 0;
    fil[l] = 0;
  }
  __syncthreads();
  for (int n = tid; n < N; n += nt)
    if (cap_s[n]) atomicAdd(&capp[leaf[n]], cap_s[n]);
  __syncthreads();
  for (int l = tid; l < N; l += nt) {
    qq[l] = quota[l] < capp[l] ? quota[l] : capp[l];
    lo[l] = 0;
    hi[l] = 1 << POUR_BITS;
  }
  __syncthreads();
  for (int step = 0; step <= POUR_BITS; ++step) {
    for (int n = tid; n < N; n += nt) {
      const int32_t cap = cap_s[n];
      if (cap > 0) {
        const int lf = leaf[n];
        const int32_t mid = lo[lf] + (hi[lf] - lo[lf] + 1) / 2;
        const int32_t d = mid - k_s[n];
        const int32_t f = d <= 0 ? 0 : (d < cap ? d : cap);
        if (f) atomicAdd(&fil[lf], f);
      }
    }
    __syncthreads();
    for (int l = tid; l < N; l += nt) {
      const int32_t mid = lo[l] + (hi[l] - lo[l] + 1) / 2;
      if (fil[l] <= qq[l]) {
        lo[l] = mid;
      } else {
        hi[l] = mid - 1;
      }
      fil[l] = 0;
    }
    __syncthreads();
  }
  long long kmax = 0;
  for (int n = tid; n < N; n += nt) {  // base counts and boundary nodes
    const int lf = leaf[n];
    const int32_t lvl = lo[lf];
    const int32_t d = lvl - k_s[n];
    const int32_t cap = cap_s[n];
    const int32_t c = d <= 0 ? 0 : (d < cap ? d : cap);
    out[(int64_t)g * N + n] = c;
    if (c) atomicAdd(&fil[lf], c);
    const bool b = cap > c && k_s[n] <= lvl && c == d;
    bnd[n] = b;
    if (b) {
      const long long key = (long long)(s.totals[n] + c) * N + n;
      kmax = key > kmax ? key : kmax;
    }
  }
  kmax = block_max(kmax, red64);
  int32_t rmax = 0;
  for (int l = tid; l < N; l += nt) {
    const int32_t r = qq[l] - fil[l];
    off[l] = r;
    klo[l] = 0;
    khi[l] = kmax;
    cnt[l] = 0;
    rmax = r > rmax ? r : rmax;
  }
  rmax = block_max(rmax, red32);
  if (rmax > 0) {
    const int steps = 65 - __clzll(kmax | 1);
    for (int it = 0; it < steps; ++it) {
      for (int n = tid; n < N; n += nt) {
        if (bnd[n]) {
          const int lf = leaf[n];
          if (off[lf] > 0 && klo[lf] < khi[lf]) {
            const long long mid = klo[lf] + (khi[lf] - klo[lf]) / 2;
            const int32_t c = out[(int64_t)g * N + n];
            if ((long long)(s.totals[n] + c) * N + n <= mid)
              atomicAdd(&cnt[lf], 1);
          }
        }
      }
      __syncthreads();
      for (int l = tid; l < N; l += nt) {
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
      __syncthreads();
    }
  }
  __syncthreads();
  for (int n = tid; n < N; n += nt) {  // final counts and the state fold
    int32_t c = out[(int64_t)g * N + n];
    if (bnd[n]) {
      const int lf = leaf[n];
      if (off[lf] > 0 && (long long)(s.totals[n] + c) * N + n <= klo[lf])
        c += 1;
    }
    out[(int64_t)g * N + n] = c;
    fold_node(a, s, g, n, N, R, PV, svc_row, c);
  }
}

}  // namespace skt

extern "C" int skt_tree_fill_scratch_i32() { return skt::TREE_I32_ARRAYS; }

extern "C" int skt_tree_fill_step(
    const void* mask, const void* need_res, const void* n_tasks,
    const void* svc_idx, const void* max_replicas, const void* penalty,
    const void* has_ports, const void* group_ports, const void* spread_rank,
    void* totals, void* svc_counts, void* avail, void* port_used, void* out,
    void* flags, void* scratch, void* scratch64, int g, int N, int R, int PV,
    int L, void* stream) {
  skt::GroupArgs a{(const uint8_t*)mask,         (const int32_t*)need_res,
                   (const int32_t*)n_tasks,      (const int32_t*)svc_idx,
                   (const int32_t*)max_replicas, (const uint8_t*)penalty,
                   (const uint8_t*)has_ports,    (const uint8_t*)group_ports};
  skt::NodeState s{(int32_t*)totals, (int32_t*)svc_counts, (int32_t*)avail,
                   (uint8_t*)port_used};
  skt::tree_fill_kernel<<<1, skt::FILL_THREADS, 0, (cudaStream_t)stream>>>(
      a, s, (const int32_t*)spread_rank, g, N, R, PV, L, (int32_t*)out,
      (int32_t*)flags, (int32_t*)scratch, (long long*)scratch64);
  return (int)cudaGetLastError();
}
