// The sharded Orzan colouring's device steps, for Hopper (sm_90a).
//
// Replaces jepsen_tpu/tpu/scc.py:172 `_jitted_scc_sharded`: the
// colouring program `_scc_program` (:64) run under shard_map with its
// edge list sharded over the mesh and `combine = pmax`, so that every
// sweep ends in one max of the colour array across the shards. That
// combine is a collective, not a kernel body, so the program cannot be
// one cooperative launch as csrc/scc.cu is: the host drives the rounds
// and sweeps (gpu/scc.py) and calls, per sweep, one `sweep` launch per
// shard over the shard's edge block, the combine (an elementwise max
// onto the first shard's device, or an all_reduce(MAX) across ranks),
// and one `apply`; per round, three `step` launches.
//
//   sweep   prop[v] = neutral, then for every edge e of the block with
//           edge_on[e], active[src] and active[dst]: forward,
//           atomicMax(prop[dst], x[src]); backward (the membership
//           pass), the ends swapped and only inside a colour class,
//           col[src] == col[dst]: atomicMax(prop[src], x[dst])
//           (tpu/scc.py:79-131). neutral is -1 forward, 0 backward.
//   apply   x = max(x, prop), and ctl[0] = 1 where any x changed.
//   step    kInit: x = active ? id : -1 (the forward colours);
//           kRoots: m = active && c == id (the roots of the backward
//           pass); kRetire: member = active && m > 0, out = c and
//           active = false on members, ctl[1] = active nodes left.
//
// Bound: bytes. A sweep reads each edge's src, dst and edge_on once (9
// bytes) and, per node, active (1 byte), x (4) and in the backward pass
// col (4), and writes prop (4); the endpoints' gathers and the atomics
// hit those same n-sized arrays, which the 50 MB L2 holds at Elle's
// sizes. So a sweep of E edges over n nodes moves at least 9E + 9n
// (forward) or 9E + 13n (backward) bytes; at phase 8's 50,000-txn
// graph (301,479 edges) that is ~3.2 MB, ~1 us at 3.35 TB/s, below a
// launch's own cost. The design is the simplest that is right: a
// grid-stride loop of 256-thread blocks, a plain load of prop[to] before
// the atomic (prop only grows within a sweep, so a stale value only
// costs an atomic that changes nothing), and block-wide ORs and counts
// before one atomic a block for the flags.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;
// the step launch's modes, mirrored by gpu/kernels/scc_shard.py
constexpr int kInit = 0;
constexpr int kRoots = 1;
constexpr int kRetire = 2;

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

__global__ void fill_kernel(int* __restrict__ a, int n, int v) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    a[i] = v;
}

__global__ void sweep_kernel(const int* __restrict__ src,
                             const int* __restrict__ dst,
                             const uint8_t* __restrict__ edge_on,
                             const uint8_t* __restrict__ active,
                             const int* __restrict__ x,
                             const int* __restrict__ col, int* prop, int e,
                             int backward) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < e;
       i += gridDim.x * blockDim.x) {
    if (!edge_on[i]) continue;
    int s = src[i], d = dst[i];
    if (!active[s] || !active[d]) continue;
    if (backward) {
      if (col[s] != col[d]) continue;
      int t = s;
      s = d;
      d = t;
    }
    int v = x[s];
    if (v > prop[d]) atomicMax(prop + d, v);
  }
}

__global__ void apply_kernel(int* __restrict__ x,
                             const int* __restrict__ prop, int n,
                             int* __restrict__ ctl) {
  int changed = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    int p = prop[i];
    if (p > x[i]) {
      x[i] = p;
      changed = 1;
    }
  }
  if (__syncthreads_or(changed) && threadIdx.x == 0) atomicOr(ctl, 1);
}

__global__ void step_kernel(int step, uint8_t* __restrict__ active,
                            int* __restrict__ c, int* __restrict__ m,
                            int* __restrict__ out, int n,
                            int* __restrict__ ctl) {
  int left = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    if (step == kInit) {
      c[i] = active[i] ? i : -1;
    } else if (step == kRoots) {
      m[i] = (active[i] && c[i] == i) ? 1 : 0;
    } else if (active[i]) {
      if (m[i] > 0) {
        out[i] = c[i];
        active[i] = 0;
      } else {
        left++;
      }
    }
  }
  if (step == kRetire) {  // uniform over the block: every lane shuffles
    for (int off = 16; off > 0; off >>= 1)
      left += __shfl_down_sync(0xffffffffu, left, off);
    if ((threadIdx.x & 31) == 0 && left) atomicAdd(ctl + 1, left);
  }
}

int record(void* ev, cudaStream_t s) {
  return ev ? (int)cudaEventRecord((cudaEvent_t)ev, s) : 0;
}

int finish(void* ev_end, cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return record(ev_end, s);
}

}  // namespace

extern "C" {

// One sweep over an edge block on `stream`: src, dst int32 [e] (each in
// [0, n)), edge_on uint8 [e], active uint8 [n], x and col int32 [n]
// (col read in the backward pass only), prop int32 [n], set to the
// neutral value and then max-propagated. ev_start / ev_end, when given,
// are recorded just before and just after the two kernels. Returns the
// CUDA error code of the launch (0 = launched).
int scc_shard_sweep_launch(const int* src, const int* dst,
                           const uint8_t* edge_on, const uint8_t* active,
                           const int* x, const int* col, int n, int e,
                           int backward, int* prop, void* stream,
                           void* ev_start, void* ev_end) {
  if (n < 1 || e < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = record(ev_start, s);
  if (err) return err;
  fill_kernel<<<blocks_for(n), kThreads, 0, s>>>(prop, n,
                                                  backward ? 0 : -1);
  if (e)
    sweep_kernel<<<blocks_for(e), kThreads, 0, s>>>(
        src, dst, edge_on, active, x, col, prop, e, backward);
  return finish(ev_end, s);
}

// x = max(x, prop) over int32 [n]; ctl int32 [2]: ctl[0] set to 1 where
// any x changed (cleared first).
int scc_shard_apply_launch(int* x, const int* prop, int n, int* ctl,
                           void* stream, void* ev_start, void* ev_end) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = record(ev_start, s);
  if (err) return err;
  err = (int)cudaMemsetAsync(ctl, 0, sizeof(int), s);
  if (err) return err;
  apply_kernel<<<blocks_for(n), kThreads, 0, s>>>(x, prop, n, ctl);
  return finish(ev_end, s);
}

// One of a round's elementwise steps (kInit, kRoots, kRetire) over
// active uint8 [n], c, m, out int32 [n]; ctl int32 [2]: kRetire clears
// ctl[1] and counts the active nodes left into it.
int scc_shard_step_launch(int step, uint8_t* active, int* c, int* m,
                          int* out, int n, int* ctl, void* stream,
                          void* ev_start, void* ev_end) {
  if (n < 1 || step < kInit || step > kRetire)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = record(ev_start, s);
  if (err) return err;
  if (step == kRetire) {
    err = (int)cudaMemsetAsync(ctl + 1, 0, sizeof(int), s);
    if (err) return err;
  }
  step_kernel<<<blocks_for(n), kThreads, 0, s>>>(step, active, c, m, out, n,
                                                 ctl);
  return finish(ev_end, s);
}

const char* scc_shard_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
