// Row reduction of the bank workload's balance matrix, for Hopper (sm_90a).
//
// Replaces the device branch of jepsen_tpu/workloads/bank.py:98-103
// `check_fast` (`jnp.sum(axis=1)` and `jnp.any(dmat < 0, axis=1)`). In one
// pass over an int64 [rows, cols] matrix it writes each row's int64 sum
// and whether the row holds a negative balance. Unlike the JAX branch,
// which narrows the matrix to int32, the sums are int64 throughout (they
// wrap only where numpy's int64 sums wrap).
//
// Design: one warp per row. Lanes read the row's neighbouring elements
// (coalesced: a 32-account row is one 256-byte read), sum in registers,
// and combine with shuffles; the negative flag is a warp vote. Bound:
// bytes. Each element is read once and each row's 9 output bytes written
// once, so at the bank history of 500k txns with 32 accounts (250k reads,
// 64 MB) the least time is about 19 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    bank_reduce_kernel(const int64_t* __restrict__ mat, long rows, int cols,
                       int64_t* __restrict__ sums,
                       uint8_t* __restrict__ negs) {
  const long row = (long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const long long* r = (const long long*)(mat + row * (long)cols);
  // unsigned: two's-complement wrap-around, as numpy's int64 sum
  unsigned long long s = 0;
  int neg = 0;
  for (int j = lane; j < cols; j += 32) {
    const long long v = __ldg(r + j);
    s += (unsigned long long)v;
    neg |= v < 0;
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  neg = __any_sync(0xffffffffu, neg);
  if (lane == 0) {
    sums[row] = (int64_t)s;
    negs[row] = neg ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Launches the reduction on `stream`: sums int64 [rows], negs uint8
// [rows]. Returns the CUDA error code of the launch (0 = launched).
int bank_reduce_launch(const int64_t* mat, long rows, int cols, int64_t* sums,
                       uint8_t* negs, void* stream) {
  if (rows < 0 || cols < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bank_reduce_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      mat, rows, cols, sums, negs);
  return (int)cudaGetLastError();
}

const char* bank_reduce_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
