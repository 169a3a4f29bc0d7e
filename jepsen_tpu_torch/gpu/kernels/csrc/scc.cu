// Strongly connected components by Orzan's colouring, as one cooperative
// kernel for Hopper (sm_90a).
//
// Replaces jepsen_tpu/tpu/scc.py:64 `_scc_program` (jitted at :156,
// launched by `scc_device`), and computes what it computes, output for
// output:
//
//   repeat (at most round_cap rounds) while nodes stay active:
//     live[e] = edge_on[e] && active[src[e]] && active[dst[e]]
//     forward:  c = active ? id : -1, then Jacobi sweeps
//               prop = max over live edges u->v of c[u] into v,
//               c = max(c, prop), to a fixpoint (at most sweep_cap)
//     backward: m = active && c == id, then the same sweeps from dst to
//               src over live edges whose ends share a colour
//     every active node with m > 0 takes label c and retires
//   ok = every fixpoint converged and no node is left active
//
// Labels are the max node id of each component. Max is independent of
// the order in which atomics land, so the labels, and the sweep and
// round counts, are exactly those of the JAX program and of the plain
// PyTorch version (gpu/kernels/scc.py:scc_labels_reference). The sweeps
// are Jacobi sweeps on purpose: an in-place atomicMax on c would
// converge in fewer sweeps and so hit the caps on other graphs than the
// reference does.
//
// Design. One launch runs the whole peeling loop: the grid is cooperative
// (cudaLaunchCooperativeKernel, sized to what can be resident), phases are
// separated by grid.sync(), and the loop's conditions are read from
// device-side flags, so the host waits for one launch and copies one
// buffer back (labels, ok, rounds, sweeps), as the JAX program does one
// download per call. Each sweep is two grid-stride passes and two grid
// syncs: the scatter over the edges (an edge whose source value does not
// exceed its target's current value cannot change the target, so it
// issues no atomic), then the update over the nodes, which also resets
// prop to the neutral value for the next sweep and raises the changed
// flag. The flags rotate over three slots so that a slot is cleared two
// syncs after its last reader.
//
// Bound. Per sweep the scatter reads the edge mask (a byte an edge) and,
// for each live edge, src, dst, the source's value and the target's prop
// (16 bytes), and the update reads and writes each node's value; the
// live edges shrink from round to round. At the list-append history of
// 100k txns (603k edges) a sweep touches at most about 11 MB, which the
// 50 MB L2 holds. The kernel is bound by the latency of its grid syncs
// and the serial chain of sweeps, not by bytes or operations.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;

struct Args {
  const int* src;
  const int* dst;
  const uint8_t* edge_on;
  int n;
  int e;
  int sweep_cap;
  int round_cap;
  uint8_t* active;  // [n] scratch: 1 while a node is not yet labelled
  uint8_t* emask;   // [e] scratch
  int* c;           // [n] scratch: colours
  int* m;           // [n] scratch: backward membership
  int* prop;        // [n] scratch
  int* flags;       // [3] scratch
  int* out;         // [n + 3]: labels, then ok, rounds, sweeps
};

__device__ __forceinline__ int read_flag(const int* flags, int slot) {
  return *((volatile const int*)(flags + slot));
}

// One Jacobi fixpoint of x along the masked edges from[e] -> to[e];
// returns 1 when it converged, and adds its sweeps to *sweeps. Every
// thread of the grid runs it with the same control flow.
__device__ int fixpoint(cg::grid_group& grid, const Args& a, int* x,
                        const int* from, const int* to, int neutral,
                        int& fi, int& sweeps) {
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long stride = (long)gridDim.x * blockDim.x;
  int it = 0;
  int changed = 1;
  while (changed && it < a.sweep_cap) {
    for (long e = tid; e < a.e; e += stride) {
      if (a.emask[e]) {
        const int v = x[from[e]];
        const int t = to[e];
        if (v > x[t]) atomicMax(&a.prop[t], v);
      }
    }
    grid.sync();
    int mine = 0;
    for (long v = tid; v < a.n; v += stride) {
      const int p = a.prop[v];
      if (p > x[v]) {
        x[v] = p;
        mine = 1;
      }
      a.prop[v] = neutral;
    }
    if (mine) atomicOr(&a.flags[fi], 1);
    if (tid == 0) a.flags[(fi + 1) % 3] = 0;
    grid.sync();
    changed = read_flag(a.flags, fi);
    fi = (fi + 1) % 3;
    ++it;
  }
  sweeps += it;
  return !changed;
}

__global__ void __launch_bounds__(kThreads) scc_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long stride = (long)gridDim.x * blockDim.x;
  int fi = 0;
  int ok = 1;
  int rounds = 0;
  int sweeps = 0;
  int any_active = a.n > 0;
  // the kernel sets up its own state, so a launch needs no fill kernels
  for (long v = tid; v < a.n; v += stride) {
    a.out[v] = -1;
    a.active[v] = 1;
  }
  if (tid < 3) a.flags[tid] = 0;
  grid.sync();
  while (ok && any_active && rounds < a.round_cap) {
    // live edges of this round; forward colours
    for (long e = tid; e < a.e; e += stride) {
      a.emask[e] = a.edge_on[e] && a.active[a.src[e]] && a.active[a.dst[e]];
    }
    for (long v = tid; v < a.n; v += stride) {
      a.c[v] = a.active[v] ? (int)v : -1;
      a.prop[v] = -1;
    }
    grid.sync();
    const int ok_f = fixpoint(grid, a, a.c, a.src, a.dst, -1, fi, sweeps);
    // backward membership inside each colour class, all roots at once
    for (long e = tid; e < a.e; e += stride) {
      if (a.emask[e] && a.c[a.src[e]] != a.c[a.dst[e]]) a.emask[e] = 0;
    }
    for (long v = tid; v < a.n; v += stride) {
      a.m[v] = (a.active[v] && a.c[v] == (int)v) ? 1 : 0;
      a.prop[v] = 0;
    }
    grid.sync();
    const int ok_b = fixpoint(grid, a, a.m, a.dst, a.src, 0, fi, sweeps);
    // retire the members; note whether any node stays active
    int mine = 0;
    for (long v = tid; v < a.n; v += stride) {
      if (a.active[v]) {
        if (a.m[v] > 0) {
          a.out[v] = a.c[v];
          a.active[v] = 0;
        } else {
          mine = 1;
        }
      }
    }
    if (mine) atomicOr(&a.flags[fi], 1);
    if (tid == 0) a.flags[(fi + 1) % 3] = 0;
    grid.sync();
    any_active = read_flag(a.flags, fi);
    fi = (fi + 1) % 3;
    ok = ok && ok_f && ok_b;
    ++rounds;
  }
  if (tid == 0) {
    a.out[a.n] = (ok && !any_active) ? 1 : 0;
    a.out[a.n + 1] = rounds;
    a.out[a.n + 2] = sweeps;
  }
}

// Blocks of the cooperative grid for a graph of n nodes and e edges: as
// many as can be resident at once, and no more than the work needs. The
// resident count is asked of the CUDA runtime once per device and kept.
int grid_blocks(int dev, int n, int e) {
  constexpr int kDevices = 64;
  static int resident[kDevices];  // 0 until asked; a race asks twice
  if (dev < 0 || dev >= kDevices) return -1;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scc_kernel,
                                                      kThreads, 0) !=
        cudaSuccess)
      return -1;
    resident[dev] = per_sm * sms;
  }
  const long work = (long)(n > e ? n : e);
  long want = (work + kThreads - 1) / kThreads;
  if (want < 1) want = 1;
  const long most = resident[dev];
  return (int)(want < most ? want : most);
}

}  // namespace

extern "C" {

// Launches the peeling loop on `stream`. The caller allocates every
// buffer, uninitialised: active and emask uint8 [max(n,1)] and
// [max(e,1)], c, m, prop int32 [max(n,1)], flags int32 [3], out int32
// [n + 3]. Returns the CUDA error code of the launch (0 = launched).
int scc_launch(const int* src, const int* dst, const uint8_t* edge_on, int n,
               int e, int sweep_cap, int round_cap, uint8_t* active,
               uint8_t* emask, int* c, int* m, int* prop, int* flags,
               int* out, void* stream) {
  if (n < 0 || e < 0 || sweep_cap < 0 || round_cap < 0)
    return (int)cudaErrorInvalidValue;
  int supported = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&supported, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!supported) return (int)cudaErrorNotSupported;
  const int blocks = grid_blocks(dev, n, e);
  if (blocks < 1) {
    err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidDevice);
  }
  Args a{src, dst, edge_on, n, e, sweep_cap, round_cap, active, emask,
         c, m, prop, flags, out};
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)scc_kernel, dim3(blocks),
                                    dim3(kThreads), params, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* scc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
