// Row reduction of the bank workload's balance matrix, for Hopper (sm_90a).
//
// Replaces the device branch of jepsen_tpu/workloads/bank.py:98-103
// `check_fast` (`jnp.sum(axis=1)` and `jnp.any(dmat < 0, axis=1)`). In one
// pass over an int64 [rows, cols] matrix it writes each row's int64 sum
// and whether the row holds a negative balance. Unlike the JAX branch,
// which narrows the matrix to int32, the sums are int64 throughout (they
// wrap only where numpy's int64 sums wrap).
//
// Bound: bytes. Each element is read once and each row's 9 output bytes
// written once, so at the bank history of 500k txns with 32 accounts
// (250k reads, 64 MB, more than the 50 MB L2) the least time is about
// 19 us at 3.35 TB/s. To reach the memory rate the kernel keeps enough
// bytes in flight on every SM to cover the latency of HBM:
//   - a group of G lanes (a power of two, G >= cols / 2 up to 32) owns a
//     row and reads it in 16-byte vectors, neighbouring lanes on
//     neighbouring addresses, so a warp reads 32 / G neighbouring rows
//     at once;
//   - each lane issues its loads for kRows rows before it uses any of
//     them, with a streaming hint (no L1 allocation, 256-byte L2
//     prefetch);
//   - the grid is persistent: as many blocks as can be resident, each
//     warp walking over steps of 32 / G * kRows neighbouring rows.
// (kRows = 2 and 512 threads a block are faster on the H100 than 4 or 8
// rows and 256 threads.)
// A row whose first element is not 16-byte aligned (an odd row width, or
// a view such as mat[1:]) reads that element alone (the head, on the
// group's last lane), then its vectors, then a last odd element alone
// (the tail, on its first lane); both are issued with the vectors. The
// group combines its lanes' sums with shuffles; the negative flag is an
// OR over the same lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 2;  // rows a lane has in flight
constexpr unsigned kFull = 0xffffffffu;

struct Pair {
  long long x, y;
};

__device__ __forceinline__ Pair load_pair(const long long* p) {
  Pair v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v2.s64 {%0, %1}, [%2];"
      : "=l"(v.x), "=l"(v.y)
      : "l"(p));
  return v;
}

__device__ __forceinline__ long long load_one(const long long* p) {
  long long x;
  asm("ld.global.nc.L1::no_allocate.s64 %0, [%1];" : "=l"(x) : "l"(p));
  return x;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    bank_reduce_kernel(const long long* __restrict__ mat, long long rows,
                       int cols, int64_t* __restrict__ sums,
                       uint8_t* __restrict__ negs) {
  constexpr int kGroups = 32 / G;  // rows a warp reads at once
  constexpr int kStep = kGroups * kRows;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int grp = lane / G;
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * kThreads) >> 5;
  for (long long r0 = warp * kStep; r0 < rows; r0 += warps * kStep) {
    const long long* rp[kRows];
    int head[kRows], nvec[kRows];
    Pair v[kRows];
    long long x[kRows];
    // issue every row's first vector, and its odd elements, before using
    // any: the head on the group's last lane, the tail on its first
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const long long row = r0 + u * kGroups + grp;
      const bool in = row < rows;
      rp[u] = mat + (in ? row : 0) * (long long)cols;
      head[u] = in && cols > 0 && ((uintptr_t)rp[u] & 15) ? 1 : 0;
      nvec[u] = in ? (cols - head[u]) >> 1 : 0;
      const bool tail = in && ((cols - head[u]) & 1);
      v[u] = gl < nvec[u] ? load_pair(rp[u] + head[u] + 2 * gl) : Pair{0, 0};
      const bool take_head = head[u] && gl == G - 1;
      const bool take_tail = tail && gl == 0;
      x[u] = take_tail ? load_one(rp[u] + cols - 1) : 0;
      if (take_head) {
        const long long h = load_one(rp[u]);
        if (take_tail)
          v[u].x = h;  // G == 1 and cols == 2: no vector, one lane
        else
          x[u] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const long long row = r0 + u * kGroups + grp;
      // unsigned: two's-complement wrap-around, as numpy's int64 sum
      unsigned long long s = (unsigned long long)v[u].x +
                             (unsigned long long)v[u].y +
                             (unsigned long long)x[u];
      int neg = (v[u].x < 0) | (v[u].y < 0) | (x[u] < 0);
      for (int j = gl + G; j < nvec[u]; j += G) {
        const Pair w = load_pair(rp[u] + head[u] + 2 * j);
        s += (unsigned long long)w.x + (unsigned long long)w.y;
        neg |= (w.x < 0) | (w.y < 0);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        s += __shfl_xor_sync(kFull, s, off);
        neg |= __shfl_xor_sync(kFull, neg, off);
      }
      if (gl == 0 && row < rows) {
        sums[row] = (int64_t)s;
        negs[row] = neg ? 1 : 0;
      }
    }
  }
}

// Lanes a row takes: the least power of two G with 2G >= cols, at most 32.
int group_for(int cols) {
  int g = 1;
  while (g < 32 && 2 * g < cols) g <<= 1;
  return g;
}

template <int G>
int launch(const long long* mat, long long rows, int cols, int64_t* sums,
           uint8_t* negs, cudaStream_t stream) {
  constexpr int kDevices = 64;
  static int resident[kDevices];  // 0 until asked; a race asks twice
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bank_reduce_kernel<G>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = per_sm * sms;
  }
  constexpr long long kRowsPerBlock = (kThreads / 32) * (32 / G) * kRows;
  long long want = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long blocks = want < resident[dev] ? want : resident[dev];
  bank_reduce_kernel<G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      mat, rows, cols, sums, negs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the reduction on `stream`: mat int64 [rows, cols], contiguous
// and 8-byte aligned; sums int64 [rows], negs uint8 [rows]. Returns the
// CUDA error code of the launch (0 = launched).
int bank_reduce_launch(const int64_t* mat, long long rows, int cols,
                       int64_t* sums, uint8_t* negs, void* stream) {
  if (rows < 0 || cols < 0 || ((uintptr_t)mat & 7))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const long long* m = (const long long*)mat;
  cudaStream_t s = (cudaStream_t)stream;
  switch (group_for(cols)) {
    case 1: return launch<1>(m, rows, cols, sums, negs, s);
    case 2: return launch<2>(m, rows, cols, sums, negs, s);
    case 4: return launch<4>(m, rows, cols, sums, negs, s);
    case 8: return launch<8>(m, rows, cols, sums, negs, s);
    case 16: return launch<16>(m, rows, cols, sums, negs, s);
    default: return launch<32>(m, rows, cols, sums, negs, s);
  }
}

const char* bank_reduce_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
