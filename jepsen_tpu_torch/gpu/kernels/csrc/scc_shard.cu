// The sharded Orzan colouring's device steps, for Hopper (sm_90a).
//
// Replaces jepsen_tpu/tpu/scc.py:172 `_jitted_scc_sharded`: the
// colouring program `_scc_program` (:64) run under shard_map with its
// edge list sharded over the mesh and `combine = pmax`, so that every
// sweep ends in one max of the colour array across the shards. That
// combine is a collective, not a kernel body, so the program cannot be
// one cooperative launch as csrc/scc.cu is: the host drives the rounds
// (gpu/scc.py) and runs each fixpoint in chunks of sweeps, a sweep being
// one `sweep` launch a device over its shards' edge blocks (blockIdx.y
// the shard) and one `apply`. A round has no launch of its own: its
// first colours, its roots and its retire (tpu/scc.py:110, :115, :119)
// are computed by the fixpoints' first sweeps and applies and by the
// `retire` that ends each backward chunk.
//
//   sweep   for every live edge (s, d) of the block: atomicMax(prop[d],
//           x[s]), prop being max-accumulated and never filled here.
//           Live: edge_on[e], active[src] and active[dst]; backward (the
//           membership pass) also col[src] == col[dst], the ends swapped
//           (tpu/scc.py:79-131). The first sweep of a fixpoint
//           (`compact`) finds the live edges in the block and appends
//           them as (s, d) pairs to the shard's `live` list, its length
//           in cnt[backward]; the later sweeps read only that list (the
//           predicate holds still through a fixpoint, as the JAX
//           program's live_e and same_color, :107 and :114). The
//           compacting sweep reads no x: the fixpoint's starting values
//           follow from what it has gathered, x[s] = s forward (active[s]
//           holds on a live edge, so c0[s] is s) and x[s] = (col[s] == s)
//           backward (m0).
//   apply   x = max(x0, prop), prop = kNeutral (the next sweep's start),
//           and the fixpoint's device state st[kState] updated by the
//           grid's last block: kSweeps + 1, and kDone set to kConverged
//           where no x changed or kCapped where kSweeps reaches `cap`.
//           x0 is x, or in the fixpoint's first apply its starting
//           values computed in registers: kForwardFirst active ? id : -1
//           (c0), kBackwardFirst active && c == id (m0).
//   retire  once the backward fixpoint is done (st[kDone] set; it
//           returns at once while kRunning): member = active && m > 0,
//           out = c and active = false on members, and the active nodes
//           left counted into st[kLeft] by the grid's last block.
//
// One neutral value serves both passes: forward colours and backward
// marks are both >= -1, so max(x, -1) = x, and the max over a node's
// in-edges with -1 or with the JAX program's 0 (backward) gives the same
// x. A chunk of K sweeps is enqueued without a wait; once st[kDone] is
// set, every later sweep and apply of the chunk returns at once, so the
// host reads (sweeps, done, left) back once a chunk and the sweeps it
// counts are the JAX program's, a SWEEP_CAP hit included. The backward
// chunk that ends its fixpoint retires the round's members and counts
// what is left, so that one read decides whether another round runs.
//
// Bound: bytes, and below a launch's own cost at Elle's sizes. A
// compacting sweep reads each edge's src, dst and edge_on once (9 bytes),
// gathers active (1) and, backward, col (4) and writes prop (4) per node
// and 8 bytes a live edge; a later sweep reads 8 bytes a live edge, x and
// prop; an apply reads and writes x and prop (16 bytes a node), a first
// apply reads active (1) and, backward, c (4) instead of x; a retire
// reads active, m and c and writes out and active (14 bytes a node). At
// phase 8's 50,000-txn graph over 4 shards (~75,000 edges a shard) that
// is ~1 MB a sweep launch, ~0.3 us at 3.35 TB/s. What costs is latency:
// each edge is a chain of dependent loads (edge, then endpoints' flags,
// then x[s] and prop[d], then the atomic). So the grid is sized from the
// card's SM count, each thread takes kEdgesPerThread edges and issues
// all their loads before the atomics, the later sweeps skip the
// predicate's gathers by reading the compacted list, the compacted
// appends cost one atomicAdd a warp (a ballot and a popc per edge slot),
// and the apply and the retire clear their own slots (the last block's
// ticket) instead of a memset launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the sweeps', the apply's and the retire's blocks: 128 threads, each
// over kEdgesPerThread edges (kNodesPerThread nodes), at most
// kBlocksPerSM a streaming multiprocessor
constexpr int kSweepThreads = 128;
constexpr int kEdgesPerThread = 4;
constexpr int kNodesPerThread = 4;
constexpr int kBlocksPerSM = 8;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
// the shards one sweep launch covers (blockIdx.y), mirrored by
// gpu/kernels/scc_shard.py; a device with more takes more launches
constexpr int kMaxShards = 8;
// the apply's start modes, mirrored by gpu/kernels/scc_shard.py: a later
// apply maxes prop into x; a fixpoint's first computes its x0 itself
constexpr int kLater = 0;
constexpr int kForwardFirst = 1;
constexpr int kBackwardFirst = 2;
// a fixpoint's device state, int32 [kState], mirrored by
// gpu/kernels/scc_shard.py: the apply's changed flag and the block
// ticket (each back to 0 when the grid's last block is done), the sweeps
// applied, whether the fixpoint is done, the active nodes the last
// retire left, and the retire's running count (back to 0 with the
// ticket)
constexpr int kChanged = 0;
constexpr int kTicket = 1;
constexpr int kSweeps = 2;
constexpr int kDone = 3;
constexpr int kLeft = 4;
constexpr int kTally = 5;
constexpr int kState = 6;
constexpr int kRunning = 0;
constexpr int kConverged = 1;
constexpr int kCapped = 2;
constexpr int kNeutral = -1;
static_assert(kLeft < kState && kSweeps + 1 == kDone && kDone + 1 == kLeft,
              "the chunk copies st[kSweeps], st[kDone] and st[kLeft] back "
              "together");

// The edge blocks of the shards one sweep launch covers, each of e
// edges, with their live lists and counts.
struct Blocks {
  const int* src[kMaxShards];
  const int* dst[kMaxShards];
  const uint8_t* edge_on[kMaxShards];
  int2* live[kMaxShards];
  int* cnt[kMaxShards];
};

// The current device's SM count, asked once a device.
int sm_count(int* out) {
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!cached[dev]) {
    int v = 0;
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    cached[dev] = v > 0 ? v : 1;
  }
  *out = cached[dev];
  return 0;
}

// Blocks for `items` at `per_block` a block, at most kBlocksPerSM an SM.
int grid_for(long long items, int per_block, int sms) {
  long long b = (items + per_block - 1) / per_block;
  long long most = (long long)sms * kBlocksPerSM;
  if (b < 1) b = 1;
  return (int)(b < most ? b : most);
}

__global__ void __launch_bounds__(kSweepThreads)
sweep_compact_kernel(Blocks b, int e, const uint8_t* __restrict__ active,
                     const int* __restrict__ col, int* prop, int backward) {
  const int* __restrict__ src = b.src[blockIdx.y];
  const int* __restrict__ dst = b.dst[blockIdx.y];
  const uint8_t* __restrict__ edge_on = b.edge_on[blockIdx.y];
  int2* __restrict__ live = b.live[blockIdx.y];
  int* cnt = b.cnt[blockIdx.y];
  // the other pass's list starts empty: the passes of a solve alternate
  if (blockIdx.x == 0 && threadIdx.x == 0) cnt[!backward] = 0;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long per = (long long)kSweepThreads * kEdgesPerThread;
  for (long long base = blockIdx.x * per; base < e;
       base += (long long)gridDim.x * per) {
    int s[kEdgesPerThread], d[kEdgesPerThread];
    bool ok[kEdgesPerThread];
#pragma unroll
    for (int j = 0; j < kEdgesPerThread; ++j) {
      long long i = base + j * kSweepThreads + threadIdx.x;
      ok[j] = i < e;
      s[j] = ok[j] ? __ldg(src + i) : 0;
      d[j] = ok[j] ? __ldg(dst + i) : 0;
      ok[j] = ok[j] && __ldg(edge_on + i);
    }
    // the predicate, and the fixpoint's starting value of the edge's
    // source: its id forward, its being a root (col == id) backward
    int v[kEdgesPerThread];
#pragma unroll
    for (int j = 0; j < kEdgesPerThread; ++j) {
      bool in = __ldg(active + s[j]) && __ldg(active + d[j]);
      if (backward) {
        int cd = __ldg(col + d[j]);
        in = in && __ldg(col + s[j]) == cd;
        v[j] = cd == d[j];
        int t = s[j];
        s[j] = d[j];
        d[j] = t;
      } else {
        v[j] = s[j];
      }
      ok[j] = ok[j] && in;
    }
    // append the warp's live edges: one atomicAdd for its slots
    unsigned ball[kEdgesPerThread];
    int total = 0;
#pragma unroll
    for (int j = 0; j < kEdgesPerThread; ++j) {
      ball[j] = __ballot_sync(kFull, ok[j]);
      total += __popc(ball[j]);
    }
    int at = 0;
    if (lane == 0 && total) at = atomicAdd(cnt + backward, total);
    at = __shfl_sync(kFull, at, 0);
#pragma unroll
    for (int j = 0; j < kEdgesPerThread; ++j) {
      int k = at + __popc(ball[j] & below);
      if (ok[j] && k < e) live[k] = make_int2(s[j], d[j]);
      at += __popc(ball[j]);
    }
    // and sweep them: every load before the atomics. prop only grows
    // within a sweep, so a stale prop[d] only costs an atomic that
    // changes nothing
    int p[kEdgesPerThread];
#pragma unroll
    for (int j = 0; j < kEdgesPerThread; ++j) {
      if (!ok[j]) v[j] = kNeutral;
      p[j] = ok[j] ? prop[d[j]] : kNeutral;
    }
#pragma unroll
    for (int j = 0; j < kEdgesPerThread; ++j)
      if (v[j] > p[j]) atomicMax(prop + d[j], v[j]);
  }
}

__global__ void __launch_bounds__(kSweepThreads)
sweep_live_kernel(Blocks b, int e, const int* __restrict__ x, int* prop,
                  int backward, const int* __restrict__ st) {
  if (__ldg(st + kDone) != kRunning) return;
  const int2* __restrict__ live = b.live[blockIdx.y];
  int count = __ldg(b.cnt[blockIdx.y] + backward);
  if (count > e) count = e;
  const long long per = (long long)kSweepThreads * kEdgesPerThread;
  for (long long base = blockIdx.x * per; base < count;
       base += (long long)gridDim.x * per) {
    int2 sd[kEdgesPerThread];
#pragma unroll
    for (int j = 0; j < kEdgesPerThread; ++j) {
      long long i = base + j * kSweepThreads + threadIdx.x;
      sd[j] = i < count ? __ldg(live + i) : make_int2(0, -1);
    }
    int v[kEdgesPerThread], p[kEdgesPerThread];
#pragma unroll
    for (int j = 0; j < kEdgesPerThread; ++j) {
      bool ok = sd[j].y >= 0;
      v[j] = ok ? __ldg(x + sd[j].x) : kNeutral;
      p[j] = ok ? prop[sd[j].y] : kNeutral;
    }
#pragma unroll
    for (int j = 0; j < kEdgesPerThread; ++j)
      if (v[j] > p[j]) atomicMax(prop + sd[j].y, v[j]);
  }
}

// c may be x itself (the forward pass), so neither is __restrict__.
__global__ void __launch_bounds__(kSweepThreads)
apply_kernel(int* x, int* __restrict__ prop, int n, int* st, int mode,
             int cap, const uint8_t* __restrict__ active, const int* c) {
  // every block reads kDone before the last block can write it: the
  // last block is the one that finds every other block's ticket taken
  if (mode == kLater && st[kDone] != kRunning) return;
  int changed = 0;
  const long long per = (long long)kSweepThreads * kNodesPerThread;
  for (long long base = blockIdx.x * per; base < n;
       base += (long long)gridDim.x * per) {
    int xs[kNodesPerThread], ps[kNodesPerThread];
#pragma unroll
    for (int j = 0; j < kNodesPerThread; ++j) {
      long long i = base + j * kSweepThreads + threadIdx.x;
      bool in = i < n;
      if (mode == kLater)
        xs[j] = in ? x[i] : 0;
      else if (mode == kForwardFirst)
        xs[j] = in && __ldg(active + i) ? (int)i : -1;
      else
        xs[j] = in && __ldg(active + i) && c[i] == (int)i;
      ps[j] = in ? prop[i] : kNeutral;
    }
#pragma unroll
    for (int j = 0; j < kNodesPerThread; ++j) {
      long long i = base + j * kSweepThreads + threadIdx.x;
      if (i < n) {
        if (ps[j] > xs[j]) {
          x[i] = ps[j];
          changed = 1;
        } else if (mode != kLater) {
          x[i] = xs[j];
        }
        if (ps[j] != kNeutral) prop[i] = kNeutral;
      }
    }
  }
  if (__syncthreads_or(changed) && threadIdx.x == 0)
    atomicOr(st + kChanged, 1);
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(st + kTicket, 1) == (int)gridDim.x - 1) {
      int ch = atomicExch(st + kChanged, 0);
      st[kTicket] = 0;
      int sweeps = (mode != kLater ? 0 : *(volatile int*)(st + kSweeps)) + 1;
      st[kSweeps] = sweeps;
      st[kDone] = !ch ? kConverged : sweeps >= cap ? kCapped : kRunning;
    }
  }
}

__global__ void __launch_bounds__(kSweepThreads)
retire_kernel(uint8_t* __restrict__ active, const int* __restrict__ c,
              const int* __restrict__ m, int* __restrict__ out, int n,
              int* st) {
  // uniform over the grid: nothing here writes kDone
  if (st[kDone] == kRunning) return;
  int left = 0;
  const long long per = (long long)kSweepThreads * kNodesPerThread;
  for (long long base = blockIdx.x * per; base < n;
       base += (long long)gridDim.x * per) {
    bool on[kNodesPerThread];
    int ms[kNodesPerThread];
#pragma unroll
    for (int j = 0; j < kNodesPerThread; ++j) {
      long long i = base + j * kSweepThreads + threadIdx.x;
      on[j] = i < n && active[i];
      ms[j] = on[j] ? m[i] : 0;
    }
#pragma unroll
    for (int j = 0; j < kNodesPerThread; ++j) {
      long long i = base + j * kSweepThreads + threadIdx.x;
      if (!on[j]) continue;
      if (ms[j] > 0) {
        out[i] = c[i];
        active[i] = 0;
      } else {
        left++;
      }
    }
  }
  left = __reduce_add_sync(kFull, left);
  if ((threadIdx.x & 31) == 0 && left) atomicAdd(st + kTally, left);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(st + kTicket, 1) == (int)gridDim.x - 1) {
      st[kLeft] = atomicExch(st + kTally, 0);
      st[kTicket] = 0;
    }
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

// One sweep over `shards` edge blocks of e edges (arrays of their
// pointers): one launch a kMaxShards of them, blockIdx.y the shard.
void sweep(int shards, const int* const* src, const int* const* dst,
           const uint8_t* const* edge_on, int2* const* live,
           int* const* cnt, int e, const uint8_t* active, const int* x,
           const int* col, int* prop, const int* st, int backward,
           int compact, int sms, cudaStream_t s) {
  for (int g = 0; g < shards; g += kMaxShards) {
    int m = shards - g < kMaxShards ? shards - g : kMaxShards;
    Blocks b = {};
    for (int i = 0; i < m; ++i) {
      b.src[i] = src[g + i];
      b.dst[i] = dst[g + i];
      b.edge_on[i] = edge_on[g + i];
      b.live[i] = live[g + i];
      b.cnt[i] = cnt[g + i];
    }
    dim3 grid(grid_for(e, kSweepThreads * kEdgesPerThread,
                       sms / m > 0 ? sms / m : 1),
              m);
    if (compact)
      sweep_compact_kernel<<<grid, kSweepThreads, 0, s>>>(
          b, e, active, col, prop, backward);
    else
      sweep_live_kernel<<<grid, kSweepThreads, 0, s>>>(b, e, x, prop,
                                                       backward, st);
  }
}

int node_grid(int n, int sms) {
  return grid_for(n, kSweepThreads * kNodesPerThread, sms);
}

void apply(int* x, int* prop, int n, int* st, int mode, int cap,
           const uint8_t* active, const int* c, int sms, cudaStream_t s) {
  apply_kernel<<<node_grid(n, sms), kSweepThreads, 0, s>>>(
      x, prop, n, st, mode, cap, active, c);
}

void retire(uint8_t* active, const int* c, const int* m, int* out, int n,
            int* st, int sms, cudaStream_t s) {
  retire_kernel<<<node_grid(n, sms), kSweepThreads, 0, s>>>(active, c, m,
                                                            out, n, st);
}

}  // namespace

extern "C" {

// One sweep of `shards` edge blocks on one device, on `stream` (see the
// header): src, dst, edge_on, live and cnt are arrays of the shards'
// pointers, each block src, dst int32 [e] (each in [0, n)), edge_on
// uint8 [e], live int32 [e][2] and cnt int32 [2] (cnt[backward] must be
// 0 when a compacting sweep starts; the compacting sweep of the other
// pass sets it so); active uint8 [n], x and col int32 [n] (x read by a
// later sweep only, col by a compacting sweep only), prop int32 [n]
// max-accumulated, and st int32 [kState] (a later sweep returns at once
// when the fixpoint is done) are the device's one copy, shared by its
// shards. ev_start / ev_end, when given, are recorded just before and
// just after the kernels. Returns the CUDA error code of the launch
// (0 = launched).
int scc_shard_sweep_launch(int shards, const int* const* src,
                           const int* const* dst,
                           const uint8_t* const* edge_on,
                           int2* const* live, int* const* cnt, int e,
                           const uint8_t* active, const int* x,
                           const int* col, int* prop, const int* st, int n,
                           int backward, int compact, void* stream,
                           void* ev_start, void* ev_end) {
  if (n < 1 || e < 1 || shards < 1) return (int)cudaErrorInvalidValue;
  int sms = 0;
  int err = sm_count(&sms);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  err = record(ev_start, s);
  if (err) return err;
  sweep(shards, src, dst, edge_on, live, cnt, e, active, x, col, prop, st,
        backward, compact, sms, s);
  return finish(ev_end, s);
}

// x = max(x0, prop) and prop = kNeutral over int32 [n], and st int32
// [kState] updated (see the header). mode kLater: x0 = x, and an apply
// of a done fixpoint returns at once; kForwardFirst / kBackwardFirst:
// the fixpoint's first apply, x0 from active uint8 [n] (and c int32 [n],
// backward), the count started whatever st holds.
int scc_shard_apply_launch(int* x, int* prop, int* st, int n, int mode,
                           int cap, const uint8_t* active, const int* c,
                           void* stream, void* ev_start, void* ev_end) {
  if (n < 1 || cap < 1 || mode < kLater || mode > kBackwardFirst)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  int err = sm_count(&sms);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  err = record(ev_start, s);
  if (err) return err;
  apply(x, prop, n, st, mode, cap, active, c, sms, s);
  return finish(ev_end, s);
}

// The round's retire over active uint8 [n], c, m and out int32 [n] once
// st int32 [kState]'s fixpoint is done (at once while it runs): members
// retire into out, st[kLeft] = the active nodes left.
int scc_shard_retire_launch(uint8_t* active, const int* c, const int* m,
                            int* out, int* st, int n, void* stream,
                            void* ev_start, void* ev_end) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  int sms = 0;
  int err = sm_count(&sms);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  err = record(ev_start, s);
  if (err) return err;
  retire(active, c, m, out, n, st, sms, s);
  return finish(ev_end, s);
}

// A chunk of k sweeps of one fixpoint over `shards` edge blocks on one
// device, all enqueued on `stream` with no wait: k times the shards'
// sweep (compacting the first time where `first`) and then the apply
// (its pass's first mode the first time where `first`); backward, then
// the retire into out int32 [n] (the colours being col, the marks x).
// The arguments up to `compact` as scc_shard_sweep_launch's. Then st's
// (sweeps, done, left) are copied to host_state int32 [3] (pinned), for
// the caller to read once it has waited on the stream. ev_start /
// ev_end, when given, are recorded just around the kernels.
int scc_shard_chunk_launch(int shards, const int* const* src,
                           const int* const* dst,
                           const uint8_t* const* edge_on,
                           int2* const* live, int* const* cnt, int e,
                           uint8_t* active, int* x, const int* col,
                           int* prop, int* st, int n, int backward, int k,
                           int first, int cap, int* out, int* host_state,
                           void* stream, void* ev_start, void* ev_end) {
  if (n < 1 || e < 1 || shards < 1 || k < 1 || cap < 1 ||
      (backward && !out))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  int err = sm_count(&sms);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  err = record(ev_start, s);
  if (err) return err;
  const int first_mode = backward ? kBackwardFirst : kForwardFirst;
  for (int it = 0; it < k; ++it) {
    int fresh = first && it == 0;
    sweep(shards, src, dst, edge_on, live, cnt, e, active, x, col, prop, st,
          backward, fresh, sms, s);
    apply(x, prop, n, st, fresh ? first_mode : kLater, cap, active, col,
          sms, s);
  }
  if (backward) retire(active, col, x, out, n, st, sms, s);
  err = finish(ev_end, s);
  if (err) return err;
  return (int)cudaMemcpyAsync(host_state, st + kSweeps, 3 * sizeof(int),
                              cudaMemcpyDeviceToHost, s);
}

const char* scc_shard_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
