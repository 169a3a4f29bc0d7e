// Batched WGL/Lowe linearizability frontier search for Hopper (sm_90a).
//
// Replaces jepsen_tpu/tpu/wgl.py:518 `_kernel` (jitted at :505 and
// launched by `_launch` at :813) and computes exactly what it computes:
// the same verdicts / reach masks, `unknown` flags, iteration count and
// per-level series (live configs, unique successors, dedup hits).
//
// A search row is a (segment, start state) pair over packed per-segment
// tables: inv_t/ret_t [K, M], trans [K, M, S], mseg [K], sufmin
// [K, M+1]. A configuration is (p, uint32 window mask over entries
// [p, p+W), model state). One BFS level linearizes one more entry in
// every live configuration; successors are deduplicated by a sort on
// the key (p, mask unsigned, state) and cut to the F smallest keys,
// with "more than F unique" or "a candidate past the window" flagged
// as overflow (the row then answers UNKNOWN, and the host search
// decides it).
//
// What bounds it. Not bytes and not arithmetic (a few hundred bytes and
// a few hundred operations a level): the chain of dependent levels. A
// row runs about as many levels as its segment has entries, one after
// another, so a launch takes (levels of its longest row) x (latency of
// one level). One thread block of 256 threads runs one row's whole level
// loop, rows in parallel; the design shortens the latency of a level.
//
// 1. inv, ret and sufmin come from a ring in shared memory, not from
//    global memory. A level takes every configuration from linearized
//    count L to L+1, and the key is normalized (the trailing ones of the
//    new mask shift into p), so p + popc(mask) == it for every
//    configuration at level it. Bit 0 of a stored mask is 0, so
//    popc(mask) <= W-1 and p is in [it-W+1, it]. A level reads the window
//    [p, p+W) and the tail entry p+W, so all its reads fall in
//    [it-W+1, it+W]: a range that moves forward one entry a level whatever
//    the data. The ring holds R = max(64, pow2 >= 4W) entries, filled in
//    chunks of C = R/4 entries. At level it the producer warps (4..7)
//    request the next chunk [hi, hi+C) as soon as hi < it+W+2+C, so
//    hi <= it+W+1+C when they do: the chunk overwrites entries up to
//    hi+C-1-R <= it+W+2C-R < it-W+1 (R >= 4W = 2W+2C), none of them live.
//    Before the step's barrier they wait for every chunk but the newest
//    (cp.async.wait_group 1), which has been in flight for about C
//    levels, so entries up to it+W+1 are in place for the next level. The
//    copies are cp.async of 4 bytes by warps that a small level leaves
//    idle, not the bulk copy engine: sufmin rows are M+1 ints long, so a
//    segment's sufmin starts on a 4-byte boundary only, where a bulk copy
//    needs 16. Reads past M return what the tables' padding would: BIG
//    for inv/ret (j >= M) and sufmin (j > M), by the same bound checks as
//    before the ring (a read of a ring slot is always in bounds; its
//    value is masked). The ring stops at M+1 entries, and a row with
//    m == 0 fills nothing. The trans rows (S ints an entry, S up to 4096)
//    stay in global memory, so a block's shared memory does not grow with
//    S: the producers pull each chunk's rows into L2 (prefetch.global.L2)
//    when they request it, and a configuration issues its one trans read
//    with its ring reads (its address needs only p and the state), so the
//    read's latency overlaps the cutoff instead of following it.
// 2. Small levels (the last level gave at most 32 successors: the
//    headline's ~6 configurations and ~10 successors) take no block
//    barrier. Warps 0..3, one on each of the SM's four schedulers,
//    expand the configurations (one lane per window slot; two
//    configurations a warp at once, written stage by stage so their
//    memory latencies overlap; __reduce_min_sync for the cutoff;
//    successors appended by ballot + popc at a position taken from a
//    shared counter) and meet at a 128-thread named barrier. Warp 0 then
//    finishes the level alone: one successor a lane, unique (key, state)
//    pairs by __match_any_sync (a lane is unique when no lower lane holds
//    the same pair), positions by ballot + popc, resolution by a ballot
//    of p < m and an OR reduction of the reach bits. The frontier is a
//    set, since the next level sorts or matches its successors again, so
//    it is kept in lane order with no sort, unless more than F pairs are
//    unique: then a register bitonic network over __shfl_xor_sync sorts
//    the lanes and the F smallest are kept. Lane order is exact because
//    at a given level either every kept configuration is live (p < m) or
//    none is: a configuration at level it has linearized exactly it
//    entries, every bit of its mask an entry in (p, m), so p < m gives
//    it <= p + (m-p-1) < m, and p == m gives it == m. The nl live ones
//    are then fp[0, nl) whatever their order (nl is 0 or all of them);
//    tests/test_torch_wgl_window.py checks this at every level of the
//    plain version. One warp expanding every configuration alone was
//    bound by its own instruction dispatch; four warps on four schedulers
//    are not. A level that gives more than 32 successors after all (a
//    crashed entry doubles them) leaves them in shared memory, and the
//    next step finishes it on the block path. The one __syncthreads a
//    step is where the block reads the next step's path from a control
//    record warp 0 wrote (double-buffered by step parity). The level
//    series go to a shared buffer of 64 levels that a producer warp adds
//    into the global series every 32 levels: a global atomic before the
//    barrier held up every level.
// 3. Large levels (the ensemble's, ~100-150 successors) run on the
//    block: all 8 warps expand, and the successors sort by one bitonic
//    network, whose strides < 32 run in registers through shuffles (one
//    pass a merge size, one pass for every merge size up to 32) and only
//    strides >= 32 through shared memory; a block scan gives the unique
//    pairs' positions. Registers are capped at 64 (4 blocks of 256
//    threads an SM, so the 1,024 crashed ensemble rows stay two waves):
//    the keys stay in shared memory between passes.
//
// Bit-exactness with the kernel it replaced. Every path expands with the
// same code and the same bound checks. The frontier is the same set of
// configurations: the F smallest unique (key, state) pairs under the
// same total order (key_gt: key unsigned, then state) whenever more than
// F are unique, else all of them; n_uniq counts every unique pair, past
// F too. A window overflow skips the configuration and flags the row.
// Reach mode ORs the bits of the kept configurations with p >= m after
// the truncation, as before. The level series are integer sums,
// order-free.
//
// The JAX kernel's slab dynamic_slice + one-hot einsum window
// extraction and its f32 clamp of positions to 2^22 are TPU layout
// choices and are not copied: int32 reads with BIG sentinels for
// out-of-range entries are the same function on the position range
// PackedBatch accepts (2m < 2^21).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBig = 1 << 30;  // encode.INF: the "never" position
constexpr int kValid = 1;
constexpr int kInvalid = 0;
constexpr int kUnknown = -1;
constexpr int kRunning = -2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kWarpMax = 32;  // successors a warp-path level holds
constexpr int kSmallWarps = 4;  // warps that expand a warp-path level
constexpr int kGroup = 2;     // configurations a warp expands at once
constexpr int kSeries = 64;   // levels of the series kept in shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a block may use

// What the next step of a row runs.
constexpr int kWarpLevel = 0;   // a whole level in warp 0
constexpr int kBlockLevel = 1;  // a whole level on the block
constexpr int kSortLevel = 2;   // the block sorts warp 0's successors

// A row's state between steps, written by warp 0's lane 0 and read by
// every thread after the step's barrier.
struct Ctl {
  int it;        // levels done
  int nf;        // live configurations (fp/fm/fs[0, nf))
  int result;    // kRunning until decided
  int ovf;       // the row overflowed at some level
  int path;      // kWarpLevel / kBlockLevel / kSortLevel
  int n;         // kSortLevel: successors waiting in keys[0, n)
  int covf;      // kSortLevel: a configuration overflowed its window
  int warp_lv;   // levels finished on the warp path
  int block_lv;  // levels finished on the block path
  int sort_lv;   // warp-path levels that sorted (more than F unique)
  uint32_t out_mask;
};

// The ring: entry j of the row's inv, ret and sufmin sits at slot
// j & mask.
struct Ring {
  int* inv;
  int* ret;
  int* suf;
  int mask;
};

// One configuration and its successors as seen by one lane (window
// slot): the lane's entry applied goes to state nxt (bit in b0), or is
// discarded as a crashed op (bit in b1).
struct Succ {
  int p;
  uint32_t mask;
  int st, nxt;
  uint32_t b0, b1;
};

__device__ __forceinline__ bool key_gt(u64 ka, int sa, u64 kb, int sb) {
  return ka > kb || (ka == kb && sa > sb);
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void prefetch_l2(const int* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_newest_pending() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies entries [lo, hi) (hi <= M+1) of the row's inv, ret and sufmin
// into the ring, thread t of np, as one cp.async group of this thread,
// and pulls the same entries' trans rows into L2.
__device__ void ring_fill(const Ring& rg, const int* inv, const int* ret,
                          const int* suf, const int* tr, int lo, int hi,
                          int M, int S, int t, int np) {
  for (int j = lo + t; j < hi; j += np) {
    const int e = j & rg.mask;
    if (j < M) {
      cp_async4(&rg.inv[e], inv + j);
      cp_async4(&rg.ret[e], ret + j);
    }
    cp_async4(&rg.suf[e], suf + j);
  }
  cp_async_commit();
  // one prefetch a 128-byte line of trans[lo*S, min(hi, M)*S)
  const long long end = (long long)min(hi, M) * S;
  for (long long x = (((long long)lo * S) & ~31ll) + 32ll * t; x < end;
       x += 32ll * np)
    prefetch_l2(tr + x);
}

// Expands the configurations f0, f0+step, ... (kGroup of them; those at
// or past nf produce nothing) of the frontier in one warp, one lane per
// window slot: inv, ret and sufmin from the ring, trans (the row's
// global table) from L2. Written stage by stage across the group (every
// load, then every cutoff, then every ballot) so the latencies of the
// kGroup chains overlap; ring reads are unconditional (a ring slot
// always exists) and out-of-range values are masked to what the tables'
// padding holds. Returns how many successors the group gives; *covf is
// set when a configuration overflows its window (entry p+W would itself
// be a candidate): it then produces nothing.
__device__ __forceinline__ int expand_group(const Ring& rg, const int* tr,
                                            const int* fp,
                                            const uint32_t* fm,
                                            const int* fs, int f0, int step,
                                            int nf, int M, int S, int W,
                                            int crash_free,
                                            Succ (&s)[kGroup], bool* covf) {
  const int lane = threadIdx.x & 31;
  const bool in_win = lane < W;
  int inv_w[kGroup], ret_w[kGroup], tmin[kGroup], tinv[kGroup], tv[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int f = min(f0 + u * step, nf - 1);
    s[u].p = fp[f];
    s[u].mask = fm[f];
    s[u].st = fs[f];
  }
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int j = s[u].p + lane, jt = s[u].p + W;
    const int a = rg.inv[j & rg.mask], b = rg.ret[j & rg.mask];
    const int x = rg.suf[jt & rg.mask], y = rg.inv[jt & rg.mask];
    const bool in = in_win && j < M;
    const int st = s[u].st;
    // the state's next code if this entry applies (0 for a state out of
    // range, as the padding gives), read before the cutoff is known
    tv[u] = in && st >= 0 && st < S ? tr[(size_t)j * S + st] : 0;
    inv_w[u] = in ? a : kBig;
    ret_w[u] = in ? b : kBig;
    tmin[u] = jt <= M ? x : kBig;
    tinv[u] = jt < M ? y : kBig;
  }
  int r[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const bool unlin =
        in_win && !((s[u].mask >> lane) & 1u) && inv_w[u] < kBig;
    r[u] = __reduce_min_sync(kFull, unlin ? ret_w[u] : kBig);
  }
  int cnt = 0;
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const bool valid = f0 + u * step < nf;
    const bool unlin =
        in_win && !((s[u].mask >> lane) & 1u) && inv_w[u] < kBig;
    const int minret = min(r[u], tmin[u]);
    const bool wovf = tinv[u] < minret;
    const bool cand = valid && !wovf && unlin && inv_w[u] < minret;
    const int nxt = cand ? tv[u] : -1;
    *covf |= valid && wovf;
    s[u].nxt = nxt;
    s[u].b0 = __ballot_sync(kFull, cand && nxt >= 0);               // apply
    s[u].b1 = __ballot_sync(kFull, cand && !crash_free && ret_w[u] == kBig);
    cnt += __popc(s[u].b0) + __popc(s[u].b1);                       // discard
  }
  return cnt;
}

// Writes a configuration's successors at keys[base...]: appliers first,
// then discarders, each in lane order. The key is normalized: the
// trailing ones of the new mask shift into p.
__device__ __forceinline__ void emit(const Succ& s, int base, int W,
                                     u64* keys, int* kst) {
  const int lane = threadIdx.x & 31;
  const uint32_t bit = 1u << lane, lt = bit - 1u;
  const bool ok0 = s.b0 & bit, ok1 = s.b1 & bit;
  if (!(ok0 || ok1)) return;
  const uint32_t nmask = s.mask | bit;
  const uint32_t holes = ~nmask;
  const int t = holes ? __ffs(holes) - 1 : 32;  // trailing ones
  const uint32_t sm = t >= W ? 0u : (nmask >> t);
  const u64 key = ((u64)(uint32_t)(s.p + t) << 32) | sm;
  if (ok0) {
    const int q = base + __popc(s.b0 & lt);
    keys[q] = key;
    kst[q] = s.nxt;
  }
  if (ok1) {
    const int q = base + __popc(s.b0) + __popc(s.b1 & lt);
    keys[q] = key;
    kst[q] = s.st;
  }
}

// Bitonic compare-exchange of element i with element i ^ j, which lane
// ^ j holds (j < 32); k is the merge size.
__device__ __forceinline__ void warp_cas(u64& key, int& st, int i, int j,
                                         int k) {
  const u64 ok = __shfl_xor_sync(kFull, key, j);
  const int os = __shfl_xor_sync(kFull, st, j);
  const bool up = (i & k) == 0;
  const bool swap = (i & j) == 0 ? key_gt(key, st, ok, os) == up
                                 : key_gt(ok, os, key, st) == up;
  if (swap) {
    key = ok;
    st = os;
  }
}

// The strides < 32 of merge sizes k0..k1 over keys[0, P), in registers:
// each warp takes groups of 32 consecutive elements.
__device__ void reg_pass(u64* keys, int* kst, int P, int k0, int k1) {
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x & ~31; b < P; b += kThreads) {
    const int i = b + lane;
    u64 key = keys[i];
    int st = kst[i];
    for (int k = k0; k <= k1; k <<= 1)
      for (int j = min(k >> 1, 16); j > 0; j >>= 1) warp_cas(key, st, i, j, k);
    keys[i] = key;
    kst[i] = st;
  }
}

// Ascending bitonic sort of (keys, kst) over P (a power of two >= 32).
// Ends with a __syncthreads.
__device__ void block_sort(u64* keys, int* kst, int P) {
  reg_pass(keys, kst, P, 2, min(P, 32));
  __syncthreads();
  for (int k = 64; k <= P; k <<= 1) {
    for (int j = k >> 1; j >= 32; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const u64 ka = keys[i], kb = keys[ixj];
          const int sa = kst[i], sb = kst[ixj];
          if (key_gt(ka, sa, kb, sb) == ((i & k) == 0)) {
            keys[i] = kb;
            keys[ixj] = ka;
            kst[i] = sb;
            kst[ixj] = sa;
          }
        }
      }
      __syncthreads();
    }
    reg_pass(keys, kst, P, k, k);
    __syncthreads();
  }
}

// Exclusive block-wide prefix sum of v; *total gets the sum. All
// threads of the block must call it. wsum holds kWarps ints.
__device__ int block_exclusive_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) wsum[lane] = w;
  }
  __syncthreads();
  const int before = warp ? wsum[warp - 1] : 0;
  *total = wsum[kWarps - 1];
  __syncthreads();
  return before + x - v;
}

// The end of a level, in warp 0 (every lane calls it): the verdict or
// reach update from the kept configurations (nk kept, nl of them with
// p < m, `bits` the reach bits of the others), the level's three counts
// into the shared series buffer, and the next step's control record.
__device__ void resolve(const Ctl& c, Ctl* nx, int* ser, int n, int n_uniq,
                        int nk, int nl, uint32_t bits, bool covf,
                        bool warp_path, int F, int reach) {
  // nl is nk or 0: a level's kept configurations are all live or all
  // done (the note at the head of this file)
  int result = c.result;
  uint32_t out_mask = c.out_mask;
  const bool new_ovf = c.ovf || covf || n_uniq > F;
  if (reach) {
    // truncation to F came first, then the done configurations retire
    // into the reach mask
    out_mask |= bits;
    if (nl == 0) result = new_ovf ? kUnknown : kInvalid;
  } else if (nl < nk) {
    result = kValid;
  } else if (n_uniq == 0) {
    result = new_ovf ? kUnknown : kInvalid;
  }
  if ((threadIdx.x & 31) == 0) {
    int* lv = ser + (c.it & (kSeries - 1)) * 3;
    lv[0] = c.nf;
    lv[1] = n_uniq;
    lv[2] = n - n_uniq;
    Ctl x = c;
    x.it = c.it + 1;
    x.nf = nl;
    x.result = result;
    x.ovf = new_ovf;
    x.out_mask = out_mask;
    x.path = n <= kWarpMax ? kWarpLevel : kBlockLevel;
    x.n = 0;
    x.covf = 0;
    x.warp_lv = c.warp_lv + (warp_path ? 1 : 0);
    x.block_lv = c.block_lv + (warp_path ? 0 : 1);
    x.sort_lv = c.sort_lv + (warp_path && n_uniq > F ? 1 : 0);
    *nx = x;
  }
}

// Adds levels [lo, hi) of the shared series buffer into the batch-summed
// level series, one level per lane of the calling warp.
__device__ void flush_series(const int* ser, int lo, int hi, int* lvl_live,
                             int* lvl_new, int* lvl_dup) {
  for (int l = lo + (threadIdx.x & 31); l < hi; l += 32) {
    const int* lv = ser + (l & (kSeries - 1)) * 3;
    if (lv[0]) atomicAdd(&lvl_live[l], lv[0]);
    if (lv[1]) atomicAdd(&lvl_new[l], lv[1]);
    if (lv[2]) atomicAdd(&lvl_dup[l], lv[2]);
  }
}

// Expansion of a whole level by warps [0, nw) (w is the caller's): warp
// w takes configurations w, w+nw, ... kGroup at a time, and appends their
// successors to keys/kst at a position taken from *ngen. The successors
// land in no fixed order: everything after sorts or matches them.
__device__ __forceinline__ void expand_level(const Ring& rg, const int* tr,
                                             const int* fp,
                                             const uint32_t* fm,
                                             const int* fs, u64* keys,
                                             int* kst, int* ngen, int* novf,
                                             int w, int nw, int nf, int M,
                                             int S, int W, int crash_free) {
  bool covf = false;
  for (int f = w; f < nf; f += nw * kGroup) {
    Succ s[kGroup];
    const int cnt = expand_group(rg, tr, fp, fm, fs, f, nw, nf, M, S, W,
                                 crash_free, s, &covf);
    if (!cnt) continue;
    int base = 0;
    if ((threadIdx.x & 31) == 0) base = atomicAdd(ngen, cnt);
    base = __shfl_sync(kFull, base, 0);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      emit(s[u], base, W, keys, kst);
      base += __popc(s[u].b0) + __popc(s[u].b1);
    }
  }
  if (covf && (threadIdx.x & 31) == 0) *novf = 1;
}

// A whole level in warp 0, no block barrier. Hands the level to the
// block path (kSortLevel) when it gives more than kWarpMax successors.
__device__ void warp_level(const Ctl& c, Ctl* nx, const Ring& rg,
                           const int* tr, u64* keys, int* kst, int* fp,
                           uint32_t* fm, int* fs, int* ser, int* ngen,
                           int* novf, int m, int M, int S, int W, int F,
                           int reach, int crash_free) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  expand_level(rg, tr, fp, fm, fs, keys, kst, ngen, novf, warp, kSmallWarps,
               c.nf, M, S, W, crash_free);
  asm volatile("bar.sync 1, %0;" ::"n"(kSmallWarps * 32) : "memory");
  if (warp != 0) return;
  const int n = *ngen;
  const bool covf = *novf != 0;
  if (n > kWarpMax) {
    if (lane == 0) {
      Ctl x = c;
      x.path = kSortLevel;
      x.n = n;
      x.covf = covf;
      *nx = x;
    }
    return;
  }
  // One successor a lane. Unique (key, state) pairs by matching: a lane
  // is unique when no lower lane holds the same pair. The frontier is a
  // set (the next level sorts its successors again), so when all unique
  // pairs fit in F they are kept in lane order, with no sort.
  u64 key = ~0ull;
  int st = 0x7fffffff;
  if (lane < n) {
    key = keys[lane];
    st = kst[lane];
  }
  const uint32_t act = n >= 32 ? kFull : (1u << n) - 1u;
  const uint32_t same =
      __match_any_sync(kFull, key) & __match_any_sync(kFull, st) & act;
  bool uniq = lane < n && __ffs(same) - 1 == lane;
  uint32_t bu = __ballot_sync(kFull, uniq);
  const int n_uniq = __popc(bu);
  if (n_uniq > F) {
    // keep the F smallest: a register bitonic sort across the lanes (the
    // padding lanes sort last), then unique pairs against the neighbour
    for (int k = 2; k <= 32; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) warp_cas(key, st, lane, j, k);
    const u64 pkey = __shfl_up_sync(kFull, key, 1);
    const int pst = __shfl_up_sync(kFull, st, 1);
    uniq = lane < n && (lane == 0 || key != pkey || st != pst);
    bu = __ballot_sync(kFull, uniq);
  }
  const int pos = __popc(bu & ((1u << lane) - 1u));
  const bool keep = uniq && pos < F;
  const int p = (int)(key >> 32);
  if (keep) {
    fp[pos] = p;
    fm[pos] = (uint32_t)key;
    fs[pos] = st;
  }
  const bool live = keep && p < m;
  const int nl = __popc(__ballot_sync(kFull, live));
  const uint32_t bits = __reduce_or_sync(
      kFull, (reach && keep && !live && st >= 0 && st < S) ? 1u << st : 0u);
  resolve(c, nx, ser, n, n_uniq, min(n_uniq, F), nl, bits, covf, true, F,
          reach);
}

// Sort, unique marking and truncation of keys[0, n) on the whole block,
// then resolution in warp 0. Every thread calls it.
__device__ void block_finish(const Ctl& c, Ctl* nx, int n, bool covf,
                             u64* keys, int* kst, int* fp, uint32_t* fm,
                             int* fs, int* wsum, int* ser, int m, int S,
                             int F, int reach) {
  const int tid = threadIdx.x, lane = tid & 31;
  int n_uniq = 0;
  if (n > 0) {
    int P = 32;
    while (P < n) P <<= 1;
    for (int i = n + tid; i < P; i += kThreads) {
      keys[i] = ~0ull;
      kst[i] = 0x7fffffff;
    }
    __syncthreads();
    block_sort(keys, kst, P);
    const int chunk = (n + kThreads - 1) / kThreads;
    const int lo = min(tid * chunk, n), hi = min(lo + chunk, n);
    int cnt = 0;
    for (int i = lo; i < hi; ++i)
      cnt += i == 0 || keys[i] != keys[i - 1] || kst[i] != kst[i - 1];
    int pos = block_exclusive_scan(cnt, wsum, &n_uniq);
    for (int i = lo; i < hi && pos < F; ++i) {
      if (i == 0 || keys[i] != keys[i - 1] || kst[i] != kst[i - 1]) {
        fp[pos] = (int)(keys[i] >> 32);
        fm[pos] = (uint32_t)keys[i];
        fs[pos] = kst[i];
        ++pos;
      }
    }
    __syncthreads();
  }
  if (tid >= 32) return;
  // nl kept configurations are live (p < m); those that reached the end
  // give their states to the reach mask
  const int nk = min(n_uniq, F);
  int nl = 0;
  uint32_t bits = 0u;
  for (int b = 0; b < nk; b += 32) {
    const int i = b + lane;
    const bool in = i < nk;
    const bool live = in && fp[i] < m;
    nl += __popc(__ballot_sync(kFull, live));
    if (reach && in && !live) {
      const int s = fs[i];
      if (s >= 0 && s < S) bits |= 1u << s;
    }
  }
  bits = __reduce_or_sync(kFull, bits);
  resolve(c, nx, ser, n, n_uniq, nk, nl, bits, covf, false, F, reach);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
wgl_search_kernel(const int* __restrict__ inv_t,
                  const int* __restrict__ ret_t,
                  const int* __restrict__ trans,
                  const int* __restrict__ mseg,
                  const int* __restrict__ sufmin,
                  const int* __restrict__ row_seg,
                  const int* __restrict__ st0, int M, int S, int W, int F,
                  int N, int R, int max_iters, int reach, int crash_free,
                  int8_t* __restrict__ result_out,
                  uint32_t* __restrict__ mask_out,
                  uint8_t* __restrict__ unknown_out,
                  int* __restrict__ it_out, int* __restrict__ lvl_live,
                  int* __restrict__ lvl_new, int* __restrict__ lvl_dup,
                  int* __restrict__ path_levels) {
  extern __shared__ unsigned long long smem[];
  u64* keys = smem;                                    // [N] (p<<32)|mask
  int* kst = reinterpret_cast<int*>(keys + N);         // [N] state
  int* fp = kst + N;                                   // [F] frontier p
  uint32_t* fm = reinterpret_cast<uint32_t*>(fp + F);  // [F] mask
  int* fs = reinterpret_cast<int*>(fm + F);            // [F] state
  int* wsum = fs + F;                                  // [kWarps]
  int* ser = wsum + kWarps;                            // [kSeries, 3]
  Ring rg;
  rg.inv = ser + kSeries * 3;  // [R]
  rg.ret = rg.inv + R;         // [R]
  rg.suf = rg.ret + R;         // [R]
  rg.mask = R - 1;
  __shared__ Ctl ctl[2];
  __shared__ int s_ngen[2], s_ovf[2];

  const int row = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int seg = row_seg[row];
  const int m = mseg[seg];
  const int s0 = st0[row];
  const int* inv = inv_t + (size_t)seg * M;
  const int* ret = ret_t + (size_t)seg * M;
  const int* tr = trans + (size_t)seg * M * S;
  const int* suf = sufmin + (size_t)seg * (M + 1);
  const int C = R / 4;
  const int end = M + 1;  // ring entries that exist: sufmin[M] is real

  if (tid == 0) {
    fp[0] = 0;
    fm[0] = 0u;
    fs[0] = s0;
    Ctl c;
    c.it = 0;
    c.nf = m == 0 ? 0 : 1;
    c.result = m == 0 ? kValid : kRunning;
    c.ovf = 0;
    c.path = kWarpLevel;
    c.n = 0;
    c.covf = 0;
    c.warp_lv = 0;
    c.block_lv = 0;
    c.sort_lv = 0;
    c.out_mask = m == 0 ? (1u << min((uint32_t)s0, 31u)) : 0u;
    ctl[0] = c;
    s_ngen[0] = s_ngen[1] = 0;
    s_ovf[0] = s_ovf[1] = 0;
  }
  // Ring bookkeeping, kept alike by the producer warps (kSmallWarps and
  // up, which a warp-path level leaves idle): entries [0, hi) were
  // requested, the newest chunk starts at hi_prev, [0, rdy) are in place.
  // The first of them also flushes the level series from `flushed`.
  int hi = 0, hi_prev = 0, rdy = 0, flushed = 0;
  if (m > 0) {
    hi = min(2 * C, end);
    ring_fill(rg, inv, ret, suf, tr, 0, hi, M, S, tid, kThreads);
    cp_async_wait_all();
    hi_prev = rdy = hi;
  }

  int par = 0;
  for (;;) {
    __syncthreads();  // the step's one barrier: ctl[par] is written
    const Ctl c = ctl[par];
    if (c.result != kRunning || c.it >= max_iters) break;
    Ctl* nx = &ctl[par ^ 1];

    if (warp >= kSmallWarps) {
      // Ring upkeep for the next level (it+1 reads up to it+W+1): request a
      // chunk one chunk ahead, wait for all but the newest.
      if (hi < end && hi < c.it + W + 2 + C) {
        const int top = min(hi + C, end);
        ring_fill(rg, inv, ret, suf, tr, hi, top, M, S,
                  tid - 32 * kSmallWarps, kThreads - 32 * kSmallWarps);
        hi_prev = hi;
        hi = top;
      }
      const int need = min(c.it + W + 2, end);
      if (rdy < need) {
        if (hi_prev >= need) {
          cp_async_wait_newest_pending();
          rdy = hi_prev;
        } else {
          cp_async_wait_all();
          rdy = hi;
        }
      }
      // levels below it are final; the buffer holds the last kSeries
      if (warp == kSmallWarps && c.it >= flushed + 32) {
        flush_series(ser, flushed, flushed + 32, lvl_live, lvl_new, lvl_dup);
        flushed += 32;
      }
      if (tid == 32 * kSmallWarps) {
        s_ngen[par ^ 1] = 0;
        s_ovf[par ^ 1] = 0;
      }
    }

    if (c.path == kWarpLevel) {
      if (warp < kSmallWarps)
        warp_level(c, nx, rg, tr, keys, kst, fp, fm, fs, ser, &s_ngen[par],
                   &s_ovf[par], m, M, S, W, F, reach, crash_free);
    } else {
      int n = c.n;
      bool covf = c.covf != 0;
      if (c.path == kBlockLevel) {
        expand_level(rg, tr, fp, fm, fs, keys, kst, &s_ngen[par], &s_ovf[par],
                     warp, kWarps, c.nf, M, S, W, crash_free);
        __syncthreads();
        n = s_ngen[par];
        covf = s_ovf[par] != 0;
      }
      block_finish(c, nx, n, covf, keys, kst, fp, fm, fs, wsum, ser, m, S,
                   F, reach);
    }
    par ^= 1;
  }

  cp_async_wait_all();  // no copy may land after the block has left
  const Ctl c = ctl[par];
  if (warp == kSmallWarps)
    flush_series(ser, flushed, c.it, lvl_live, lvl_new, lvl_dup);
  if (tid == 0) {
    const int result = c.result == kRunning ? kUnknown : c.result;
    result_out[row] = (int8_t)result;
    mask_out[row] = c.out_mask;
    unknown_out[row] = (result == kUnknown) || c.ovf;
    atomicMax(it_out, c.it);
    if (path_levels) {
      atomicAdd(&path_levels[0], c.warp_lv);
      atomicAdd(&path_levels[1], c.block_lv);
      atomicAdd(&path_levels[2], c.sort_lv);
    }
  }
}

// Slots of the successor buffer: a power of two (the bitonic network's
// size) that holds every successor a level can give.
long successor_slots(int W, int F, int crash_free) {
  const long cap = (long)F * W * (crash_free ? 1 : 2);
  long n = 1;
  while (n < cap) n <<= 1;
  return n;
}

int ring_entries(int W) {
  int r = 64;
  while (r < 4 * W) r <<= 1;
  return r;
}

}  // namespace

extern "C" {

// Shared memory one block of the search needs, in bytes: the successor
// buffer, the frontier, the scan's partial sums, the level series buffer
// and the ring (inv, ret, sufmin; not trans, so S does not count).
size_t wgl_search_smem_bytes(int W, int F, int crash_free) {
  return (size_t)successor_slots(W, F, crash_free) *
             (sizeof(u64) + sizeof(int)) +
         (size_t)F * 3 * sizeof(int) + kWarps * sizeof(int) +
         (size_t)kSeries * 3 * sizeof(int) +
         (size_t)ring_entries(W) * 3 * sizeof(int);
}

// Launches the search over B rows on `stream`. Outputs: result int8 [B],
// out_mask uint32 [B], unknown uint8 [B]; it_out int32 [1] and
// lvl_live/lvl_new/lvl_dup int32 [max_iters] must be zeroed by the
// caller. path_levels (int32 [3], or NULL) gets, summed over the rows,
// the levels finished on the warp path, those finished on the block path
// and those of the warp path that sorted (more than F unique) added.
// Returns the CUDA error code of the launch (0 = launched).
int wgl_search_launch(const int* inv_t, const int* ret_t, const int* trans,
                      const int* mseg, const int* sufmin,
                      const int* row_seg, const int* st0, int B, int M,
                      int S, int W, int F, int max_iters, int reach,
                      int crash_free, int8_t* result, uint32_t* out_mask,
                      uint8_t* unknown, int* it_out, int* lvl_live,
                      int* lvl_new, int* lvl_dup, int* path_levels,
                      void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || W > 32 || F < 1 || M < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = wgl_search_smem_bytes(W, F, crash_free);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int N = (int)successor_slots(W, F, crash_free);
  const int R = ring_entries(W);
  cudaError_t e = cudaFuncSetAttribute(
      wgl_search_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(wgl_search_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  wgl_search_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      inv_t, ret_t, trans, mseg, sufmin, row_seg, st0, M, S, W, F, N, R,
      max_iters, reach, crash_free, result, out_mask, unknown, it_out,
      lvl_live, lvl_new, lvl_dup, path_levels);
  return (int)cudaGetLastError();
}

const char* wgl_search_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
