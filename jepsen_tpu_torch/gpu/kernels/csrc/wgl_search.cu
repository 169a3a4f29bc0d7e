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
// Layout. One thread block per search row runs the row's own level
// loop to its end, so there is no host round trip per level. The
// frontier (F configurations) and the successor buffer live in shared
// memory. Per level:
//   1. one warp per configuration, one lane per window slot: gather
//      inv/ret/trans straight from global memory (a segment's tables
//      are a few MB and stay in L2), a warp-min gives the candidate
//      cutoff, a ballot compacts the successors into the buffer;
//   2. bitonic sort of the next power of two above the successor count
//      (not of the whole F*W buffer: most levels have a handful);
//   3. unique marking + block prefix sum keeps the first F unique keys;
//   4. resolution, and the level's three counts are atomically added
//      into the batch-summed series (integer atomics: order-free, so
//      the sums are deterministic).
//
// What bounds it on this card: not bytes and not arithmetic. Each
// level is a chain of dependent steps (global gathers, ~log2(n)^2/2
// sort stages, a scan), each ending in __syncthreads, and a row runs
// up to M+4 levels one after another, so a launch takes about
// (levels of its longest row) x (latency of one level); the gathers
// are a few hundred bytes per level. Rows run in parallel as blocks
// (several per SM: shared memory is ~24 KB per block at the headline's
// W=24, F=48), so the batch costs about one row's chain as long as the
// rows fit on the 132 SMs at once. The simple design keeps the chain
// short by sorting only the successors a level really produced; a
// later kernel could keep whole levels inside one warp.
//
// The JAX kernel's slab dynamic_slice + one-hot einsum window
// extraction and its f32 clamp of positions to 2^22 are TPU layout
// choices and are not copied: direct int32 gathers with BIG sentinels
// for out-of-range reads (inv/ret/sufmin -> BIG, trans -> -1) are the
// same function on the position range PackedBatch accepts (2m < 2^21).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;  // encode.INF: the "never" position
constexpr int kValid = 1;
constexpr int kInvalid = 0;
constexpr int kUnknown = -1;
constexpr int kRunning = -2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a block may use

__device__ __forceinline__ bool key_gt(uint64_t ka, int sa, uint64_t kb,
                                       int sb) {
  return ka > kb || (ka == kb && sa > sb);
}

// Ascending bitonic sort of (keys, kst) pairs over n = power of two.
__device__ void bitonic_sort(uint64_t* keys, int* kst, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t ka = keys[i], kb = keys[ixj];
          const int sa = kst[i], sb = kst[ixj];
          const bool up = (i & k) == 0;
          if (key_gt(ka, sa, kb, sb) == up) {
            keys[i] = kb;
            keys[ixj] = ka;
            kst[i] = sb;
            kst[ixj] = sa;
          }
        }
      }
      __syncthreads();
    }
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

__global__ void __launch_bounds__(kThreads)
wgl_search_kernel(const int* __restrict__ inv_t,
                  const int* __restrict__ ret_t,
                  const int* __restrict__ trans,
                  const int* __restrict__ mseg,
                  const int* __restrict__ sufmin,
                  const int* __restrict__ row_seg,
                  const int* __restrict__ st0, int M, int S, int W, int F,
                  int N, int max_iters, int reach, int crash_free,
                  int8_t* __restrict__ result_out,
                  uint32_t* __restrict__ mask_out,
                  uint8_t* __restrict__ unknown_out,
                  int* __restrict__ it_out, int* __restrict__ lvl_live,
                  int* __restrict__ lvl_new, int* __restrict__ lvl_dup) {
  extern __shared__ unsigned long long smem[];
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);  // [N] (p<<32)|mask
  int* kst = reinterpret_cast<int*>(keys + N);         // [N] state
  int* fp = kst + N;                                   // [F] frontier p
  uint32_t* fm = reinterpret_cast<uint32_t*>(fp + F);  // [F] mask
  int* fs = reinterpret_cast<int*>(fm + F);            // [F] state
  int* wsum = fs + F;                                  // [kWarps]
  __shared__ int s_ngen, s_ovf, s_nf;

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg = row_seg[row];
  const int m = mseg[seg];
  const int s0 = st0[row];
  const int* inv = inv_t + (size_t)seg * M;
  const int* ret = ret_t + (size_t)seg * M;
  const int* tr = trans + (size_t)seg * M * S;
  const int* suf = sufmin + (size_t)seg * (M + 1);

  // Row state, kept identical in every thread of the block.
  int result = m == 0 ? kValid : kRunning;
  bool ovf = false;
  uint32_t out_mask = m == 0 ? (1u << min((uint32_t)s0, 31u)) : 0u;
  int it = 0;
  if (tid == 0) {
    fp[0] = 0;
    fm[0] = 0u;
    fs[0] = s0;
    s_nf = m == 0 ? 0 : 1;
  }
  __syncthreads();

  while (result == kRunning && it < max_iters) {
    const int nf = s_nf;
    if (tid == 0) {
      s_ngen = 0;
      s_ovf = 0;
    }
    __syncthreads();

    // 1. successors of every live configuration
    for (int f = warp; f < nf; f += kWarps) {
      const int p = fp[f];
      const uint32_t mask = fm[f];
      const int st = fs[f];
      const int j = p + lane;
      const bool in_win = lane < W;
      int inv_w = kBig, ret_w = kBig;
      if (in_win && j < M) {
        inv_w = inv[j];
        ret_w = ret[j];
      }
      const bool unlin = in_win && !((mask >> lane) & 1u) && inv_w < kBig;
      int r = unlin ? ret_w : kBig;
      for (int o = 16; o > 0; o >>= 1)
        r = min(r, __shfl_xor_sync(kFull, r, o));
      const int jt = p + W;
      const int tail_min = jt <= M ? suf[jt] : kBig;
      const int tail_inv = jt < M ? inv[jt] : kBig;
      const int minret = min(r, tail_min);
      if (tail_inv < minret) {
        // window overflow: entry p+W would itself be a candidate; the
        // configuration produces nothing and flags the row
        if (lane == 0) s_ovf = 1;
        continue;
      }
      const bool cand = unlin && inv_w < minret;
      int nxt = -1;
      if (cand) nxt = (st >= 0 && st < S) ? tr[(size_t)j * S + st] : 0;
      const bool ok0 = cand && nxt >= 0;                         // apply
      const bool ok1 = cand && !crash_free && ret_w == kBig;     // discard
      const uint32_t b0 = __ballot_sync(kFull, ok0);
      const uint32_t b1 = __ballot_sync(kFull, ok1);
      if (!(b0 | b1)) continue;
      int base = 0;
      if (lane == 0) base = atomicAdd(&s_ngen, __popc(b0) + __popc(b1));
      base = __shfl_sync(kFull, base, 0);
      if (ok0 || ok1) {
        const uint32_t nmask = mask | (1u << lane);
        const uint32_t holes = ~nmask;
        const int t = holes ? __ffs(holes) - 1 : 32;  // trailing ones
        const uint32_t sm = t >= W ? 0u : (nmask >> t);
        const uint64_t key = ((uint64_t)(uint32_t)(p + t) << 32) | sm;
        const uint32_t lt = (1u << lane) - 1u;
        if (ok0) {
          const int q = base + __popc(b0 & lt);
          keys[q] = key;
          kst[q] = nxt;
        }
        if (ok1) {
          const int q = base + __popc(b0) + __popc(b1 & lt);
          keys[q] = key;
          kst[q] = st;
        }
      }
    }
    __syncthreads();
    const int n = s_ngen;
    const bool cfg_ovf = s_ovf != 0;

    // 2-3. sort, mark unique keys, keep the F smallest
    int n_uniq = 0;
    if (n > 0) {
      int P = 1;
      while (P < n) P <<= 1;
      for (int i = n + tid; i < P; i += kThreads) {
        keys[i] = ~0ull;
        kst[i] = 0x7fffffff;
      }
      __syncthreads();
      bitonic_sort(keys, kst, P);
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

    // 4. resolution. Kept keys are sorted by p, so the configurations
    // that reached the end (p >= m) are the tail of the kept prefix.
    const int nk = min(n_uniq, F);
    int nl = 0;
    while (nl < nk && fp[nl] < m) ++nl;
    const bool new_ovf = ovf || cfg_ovf || n_uniq > F;
    if (reach) {
      // truncation to F came first, then the done configurations
      // retire into the reach mask
      uint32_t bits = 0u;
      for (int i = nl; i < nk; ++i) {
        const int s = fs[i];
        if (s >= 0 && s < S) bits |= 1u << s;
      }
      out_mask |= bits;
      if (nl == 0) result = new_ovf ? kUnknown : kInvalid;
    } else if (nl < nk) {
      result = kValid;
    } else if (n_uniq == 0) {
      result = new_ovf ? kUnknown : kInvalid;
    }
    ovf = new_ovf;
    if (tid == 0) {
      atomicAdd(&lvl_live[it], nf);
      atomicAdd(&lvl_new[it], n_uniq);
      atomicAdd(&lvl_dup[it], n - n_uniq);
      s_nf = nl;
    }
    ++it;
    __syncthreads();
  }

  if (result == kRunning) result = kUnknown;
  if (tid == 0) {
    result_out[row] = (int8_t)result;
    mask_out[row] = out_mask;
    unknown_out[row] = (result == kUnknown) || ovf;
    atomicMax(it_out, it);
  }
}

}  // namespace

extern "C" {

// Shared memory one block of the search needs, in bytes.
size_t wgl_search_smem_bytes(int W, int F, int crash_free) {
  const long cap = (long)F * W * (crash_free ? 1 : 2);
  long n = 1;
  while (n < cap) n <<= 1;
  return (size_t)n * (sizeof(uint64_t) + sizeof(int)) +
         (size_t)F * 3 * sizeof(int) + kWarps * sizeof(int);
}

// Launches the search over B rows on `stream`. Outputs: result int8 [B],
// out_mask uint32 [B], unknown uint8 [B]; it_out int32 [1] and
// lvl_live/lvl_new/lvl_dup int32 [max_iters] must be zeroed by the
// caller. Returns the CUDA error code of the launch (0 = launched).
int wgl_search_launch(const int* inv_t, const int* ret_t, const int* trans,
                      const int* mseg, const int* sufmin,
                      const int* row_seg, const int* st0, int B, int M,
                      int S, int W, int F, int max_iters, int reach,
                      int crash_free, int8_t* result, uint32_t* out_mask,
                      uint8_t* unknown, int* it_out, int* lvl_live,
                      int* lvl_new, int* lvl_dup, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || W > 32 || F < 1 || M < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = wgl_search_smem_bytes(W, F, crash_free);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long cap = (long)F * W * (crash_free ? 1 : 2);
  int N = 1;
  while (N < cap) N <<= 1;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wgl_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  wgl_search_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      inv_t, ret_t, trans, mseg, sufmin, row_seg, st0, M, S, W, F, N,
      max_iters, reach, crash_free, result, out_mask, unknown, it_out,
      lvl_live, lvl_new, lvl_dup);
  return (int)cudaGetLastError();
}

const char* wgl_search_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
