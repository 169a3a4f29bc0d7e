// Strongly connected components by Orzan's colouring, as cooperative
// kernels for Hopper (sm_90a).
//
// Replaces jepsen_tpu/tpu/scc.py:64 `_scc_program` (jitted at :156,
// launched by `scc_device`). Two kernels:
//
// scc_kernel, the capped launch, computes what `_scc_program` computes,
// output for output:
//
//   repeat (at most round_cap rounds) while nodes stay active:
//     live[e] = edge_on[e] && active[src[e]] && active[dst[e]]
//     forward:  c = active ? id : -1, then Jacobi sweeps
//               c'[v] = max(c[v], max over live edges u->v of c[u])
//               to a fixpoint (at most sweep_cap)
//     backward: m = active && c == id, then the same sweeps from dst to
//               src over live edges whose ends share a colour
//     every active node with m > 0 takes label c and retires
//   ok = every fixpoint converged and no node is left active
//
// Labels are the max node id of each component. Max is independent of
// the order in which atomics land, so the labels, and the sweep and
// round counts, are exactly those of the JAX program and of the plain
// PyTorch version (gpu/kernels/scc.py:scc_labels_reference). The sweeps
// stay Jacobi sweeps: an in-place atomicMax would converge in fewer
// sweeps and hit the caps on other graphs than the reference does.
//
// scc_converge_kernel, the launch made after a cap hit, returns the same
// labels on any graph with no caps, in time that does not grow with the
// square of a chain's length, of nodes or of cycles (see its own note
// below).
//
// Design of the capped launch. One launch runs the whole peeling loop:
// the grid is cooperative (sized to what can be resident), phases are
// separated by grid.sync(), and the loop's conditions are read from
// device-side slots, so the host waits for one launch and copies one
// buffer back (labels, ok, rounds, sweeps). The grid syncs are what
// bound it, so the design spends as few as it can:
//   - One sync a sweep. Colours live in two buffers; sweep g reads one
//     and writes the other. Its edge pass does atomicMax(next[t],
//     cur[s]) only where cur[s] > cur[t], and its node pass copies the
//     nodes that changed in sweep g-1 (the only ones where the buffers
//     differ) with atomicMax. Max does not depend on the order of the
//     atomics, so the sweep is the reference's Jacobi sweep.
//   - A first sweep that changes nothing settles the round. Colours
//     start as ids, so then every active node is a root and the member
//     of its own class: the round retires them all in one node pass,
//     with no cut, no backward pass and no sync after it. In round 1
//     (every node active, live = edge_on) that test needs no colours:
//     some edge of the subset goes from a higher id to a lower one. The
//     launch's first pass sets up the state, writes every label as its
//     node's id and makes that test, so a valid history (a DAG whose
//     ids follow history order) costs one pass and one grid sync.
//   - Live edges as a compact list of (src, dst), built during round
//     1's first real sweep and, for each later round, from the previous
//     list while the members of the round retire. The same-colour edges
//     are cut from it the same way. Later sweeps touch only listed
//     edges, never a mask of all E. Each block keeps its own segment of
//     a list (its length in shared memory, warp-aggregated appends), so
//     appends never meet on one global counter: with one counter, the
//     19k appends of a 603k-edge list cost ~19 us on the H100.
//   - Work proportional to change. A node that changed in sweep g
//     carries the stamp g; sweep g+1 skips an edge whose source has no
//     such stamp after reading only its src: the target already holds
//     at least that source's value.
//   - Empty work costs no pass: a fixpoint over no edges is one sweep
//     that changes nothing, counted without a pass or a sync (a round
//     whose live list is empty takes the path above).
//   - Each slot of loop state (changed flag, list lengths, any node
//     active) is written before a sync and read after it; three slots
//     rotate, so a slot is cleared two syncs after its last reader.
// A round that goes on past its first sweep costs one sync a forward
// sweep, the same-colour cut, one sync a backward sweep and the retire
// pass (which lists the next round's live edges and sets its colours).
//
// Bound. The passes read the edge list (8 bytes a listed edge, 4 when
// its source did not change), and the colours of the ends of changed
// edges; at the list-append history of 100k txns (603k edges) a pass
// touches at most about 10 MB, which the 50 MB L2 holds. The kernel is
// bound by the latency of its grid syncs and the serial chain of
// sweeps, not by bytes or operations.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBlocks = 1024;
constexpr int kMaxEdges = 1 << 30;  // keeps every grid-stride index an int

// A slot of loop state, written before a sync and read after it.
constexpr int kSlot = 8;
enum { kChanged = 0, kCountA = 1, kCountB = 2, kAny = 3, kWork = 4 };

// The threads of the cooperative loop and its syncs. In the one-block
// tail (convergence launch only) block 0 runs alone and syncs with
// __syncthreads; otherwise a sync is cooperative groups' grid.sync().
struct Sync {
  cg::grid_group grid;
  int* ctl;  // [3 * kSlot]
  int tid, stride, lane;
  int j;  // syncs so far
  int grid_syncs, block_syncs;
  bool tail;

  __device__ int* slot(int k) const { return ctl + kSlot * (k % 3); }
  // where this phase writes its results
  __device__ int* put(int field) const { return slot(j) + field; }
  // what the phase before the last sync wrote
  __device__ int got(int field) const {
    return *((volatile const int*)(slot(j - 1) + field));
  }
  __device__ void sync() {
    if (tid == 0) {
      int* next = slot(j + 1);
      for (int i = 0; i < kSlot; ++i) next[i] = 0;
    }
    if (tail) {
      __syncthreads();
      ++block_syncs;
    } else {
      grid.sync();
      ++grid_syncs;
    }
    ++j;
  }
};

__device__ __forceinline__ Sync make_sync(int* ctl) {
  Sync s{cg::this_grid(), ctl, (int)(blockIdx.x * blockDim.x + threadIdx.x),
         (int)(gridDim.x * blockDim.x), (int)(threadIdx.x & 31), 0, 0, 0,
         false};
  return s;
}

// Warp-aggregated append of x (and y) where pred holds: one atomic a
// warp. Every lane of the warp must call it.
__device__ __forceinline__ void append(bool pred, int lane, int* count,
                                       int* xs, int x, int* ys = nullptr,
                                       int y = 0) {
  const unsigned b = __ballot_sync(kFull, pred);
  if (!b) return;
  const int leader = __ffs(b) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(b));
  base = __shfl_sync(kFull, base, leader);
  if (pred) {
    const int at = base + __popc(b & ((1u << lane) - 1u));
    xs[at] = x;
    if (ys) ys[at] = y;
  }
}

__device__ __forceinline__ void raise_any(int mine, int lane, int* flag) {
  if (__any_sync(kFull, mine) && lane == 0) atomicOr(flag, 1);
}

// ---------------------------------------------------------------------
// The capped launch.

struct Capped {
  const int* src;
  const int* dst;
  const uint8_t* edge_on;
  int n, e, sweep_cap, round_cap;
  uint8_t* active;  // [n]: 1 while a node is not yet labelled
  int* c[2];        // [n] colour buffers
  int* m[2];        // [n] membership buffers
  int* stamp[2];    // [n] the sweep in which a node last changed
  int* ls[2];       // [e + kMaxBlocks] edge lists, src, a segment a block
  int* ld[2];       // [e + kMaxBlocks] edge lists, dst
  int* block_flag;  // [kMaxBlocks]
  int* ctl;
  int* out;    // [n + 3]: labels, then ok, rounds, sweeps
  int* syncs;  // optional [2]: grid syncs, tail barriers
};

// Items a thread takes at once in a pass over a list, so that their
// loads (each a round trip to L2) overlap.
constexpr int kBatch = 4;

// Sweep g (the fixpoint's k-th) over this block's segment of a listed
// edges, from[i] -> to[i] for i < count: reads xr, writes xw, raises the
// changed flag. The node pass covers the whole grid.
__device__ __forceinline__ void sweep_list(Sync& S, const Capped& a,
                                           const int* from, const int* to,
                                           int count,
                                           const int* __restrict__ xr,
                                           int* __restrict__ xw, int g,
                                           bool first) {
  const int* st_r = a.stamp[(g - 1) & 1];
  int* st_w = a.stamp[g & 1];
  int mine = 0;
  if (!first) {
    for (int v = S.tid; v < a.n; v += S.stride)
      if (st_r[v] == g - 1) atomicMax(&xw[v], xr[v]);
  }
  const int step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < count; i0 += kBatch * step) {
    int s[kBatch], t[kBatch], vs[kBatch], vt[kBatch];
    bool go[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      go[u] = i0 + u * step < count;
      s[u] = go[u] ? from[i0 + u * step] : 0;
    }
    if (!first) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) go[u] = go[u] && st_r[s[u]] == g - 1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      vs[u] = go[u] ? xr[s[u]] : 0;
      t[u] = go[u] ? to[i0 + u * step] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) vt[u] = go[u] ? xr[t[u]] : 0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (go[u] && vs[u] > vt[u]) {
        atomicMax(&xw[t[u]], vs[u]);
        st_w[t[u]] = g;
        mine = 1;
      }
    }
  }
  raise_any(mine, S.lane, S.put(kChanged));
}

// A warp-uniform pass over this block's segment of a list (count items),
// kBatch items a thread at once: keep(s, t) decides, with the loads of
// both ends' values issued together, which (s, t) to append to the
// segment (out_s, out_d) whose length is *len.
template <typename Keep>
__device__ __forceinline__ void filter_list(const Sync& S, const int* fs,
                                            const int* fd, int count,
                                            Keep keep, int* len, int* out_s,
                                            int* out_d) {
  const int step = blockDim.x;
  for (int b0 = (int)threadIdx.x - S.lane; b0 < count; b0 += kBatch * step) {
    int s[kBatch], t[kBatch];
    bool in[kBatch], k[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = b0 + u * step + S.lane;
      in[u] = i < count;
      s[u] = in[u] ? fs[i] : 0;
      t[u] = in[u] ? fd[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) k[u] = in[u] && keep(s[u], t[u]);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      append(k[u], S.lane, len, out_s, s[u], out_d, t[u]);
  }
}

// Retires every active node as its own root: what a round does whose
// first forward sweep changes nothing (every active node keeps its own
// id as colour, so each is a root and the member of its own class).
__device__ __forceinline__ void retire_all_as_roots(Sync& S, const Capped& a) {
  for (int v = S.tid; v < a.n; v += S.stride) {
    if (a.active[v]) {
      a.out[v] = v;
      a.active[v] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) scc_kernel(Capped a) {
  Sync S = make_sync(a.ctl);
  const int n = a.n;
  int ok = 1, rounds = 0, sweeps = 0, any_active = n > 0, g = 0;
  const bool run = any_active && a.round_cap > 0;
  // Round 1, set up and test: the kernel sets up its own state, so a
  // launch needs no fill kernels, and every node is active with its own
  // id as colour, so the first forward sweep changes something iff some
  // edge of the subset goes from a higher id to a lower one. The labels
  // are written as if it did not (every node its own component), which
  // is the answer for a valid history.
  for (int v = S.tid; v < n; v += S.stride) {
    a.out[v] = v;
    a.active[v] = 1;
    a.c[0][v] = a.c[1][v] = v;
    a.stamp[0][v] = a.stamp[1][v] = 0;
  }
  if (S.tid == 0)
    for (int i = 0; i < 3 * kSlot; ++i) a.ctl[i] = 0;
  // the test's answer, from one flag a block (the slots are being cleared)
  int descends = 0;
  if (run && a.sweep_cap > 0) {
    int mine = 0;
    for (int i0 = S.tid; i0 < a.e; i0 += kBatch * S.stride) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * S.stride;
        if (i < a.e && __ldg(a.edge_on + i) &&
            __ldg(a.src + i) > __ldg(a.dst + i))
          mine = 1;
      }
    }
    mine = __syncthreads_or(mine);
    if (threadIdx.x == 0) a.block_flag[blockIdx.x] = mine;
    S.sync();
    const volatile int* flag = a.block_flag;
    descends = __syncthreads_or(
        (int)threadIdx.x < (int)gridDim.x ? flag[threadIdx.x] : 0);
  }
  if (!run) {
    for (int v = S.tid; v < n; v += S.stride) a.out[v] = -1;
  } else if (a.sweep_cap == 0) {
    // no sweep may run: colours stay ids, each node is its own root, and
    // both fixpoints fail to converge
    ok = 0;
    rounds = 1;
    any_active = 0;
  } else if (!descends) {
    rounds = 1;
    sweeps = 2;
    any_active = 0;
  } else {
    // sweep 1 for real: list the live edges (edge_on: every node is
    // active) and raise the targets of the descending ones. Each block
    // lists the edges of its own chunk into its own segment of the list,
    // with its length in shared memory, and later passes over a list
    // read the block's segment: appends never meet on one counter.
    __shared__ int s_len[2];
    const int chunk = (a.e + (int)gridDim.x - 1) / (int)gridDim.x;
    const int base = (int)blockIdx.x * chunk;
    g = 1;
    if (threadIdx.x == 0) s_len[0] = 0;
    __syncthreads();
    for (int v = S.tid; v < n; v += S.stride) a.out[v] = -1;
    const int hi = min(a.e, base + chunk);
    const int step = blockDim.x;
    for (int b0 = base + (int)threadIdx.x - S.lane; b0 < hi;
         b0 += kBatch * step) {
      int s[kBatch], t[kBatch];
      bool on[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = b0 + u * step + S.lane;
        on[u] = i < hi && __ldg(a.edge_on + i);
        s[u] = i < hi ? __ldg(a.src + i) : 0;
        t[u] = i < hi ? __ldg(a.dst + i) : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        append(on[u], S.lane, &s_len[0], a.ls[0] + base, s[u],
               a.ld[0] + base, t[u]);
        if (on[u] && s[u] > t[u]) {
          atomicMax(&a.c[1][t[u]], s[u]);
          a.stamp[1][t[u]] = g;
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0 && s_len[0]) atomicAdd(S.put(kCountA), s_len[0]);
    S.sync();
    int n_live = S.got(kCountA);
    int L = 0;  // the live list is ls[L], ld[L]; the same-colour list the other
    int len_live = s_len[0];  // this block's segments
    while (true) {
      // forward colours
      int k = 0, changed = 1;
      const int* fs = a.ls[L] + base;
      const int* fd = a.ld[L] + base;
      if (rounds == 0) {
        k = 1;  // sweep 1 ran above, and changed something
      } else {
        if (n_live == 0) {
          k = 1;  // a sweep over no edge, counted without a pass
          changed = 0;
        } else {
          ++k;
          ++g;
          sweep_list(S, a, fs, fd, len_live, a.c[0], a.c[1], g, true);
          S.sync();
          changed = S.got(kChanged);
        }
        if (!changed) {
          retire_all_as_roots(S, a);
          sweeps += 2;
          ++rounds;
          any_active = 0;
          break;
        }
      }
      while (changed && k < a.sweep_cap) {
        ++k;
        ++g;
        sweep_list(S, a, fs, fd, len_live, a.c[(k - 1) & 1], a.c[k & 1], g,
                   false);
        S.sync();
        changed = S.got(kChanged);
      }
      const int ok_f = !changed;
      sweeps += k;
      const int* c = a.c[k & 1];
      // the same-colour cut of the live list, and the roots
      int* ss = a.ls[1 - L] + base;
      int* sd = a.ld[1 - L] + base;
      if (threadIdx.x == 0) s_len[1 - L] = 0;
      __syncthreads();
      filter_list(
          S, fs, fd, len_live, [c](int s, int t) { return c[s] == c[t]; },
          &s_len[1 - L], ss, sd);
      for (int v = S.tid; v < n; v += S.stride) {
        if (a.active[v]) a.m[0][v] = a.m[1][v] = c[v] == v ? 1 : 0;
      }
      __syncthreads();
      if (threadIdx.x == 0 && s_len[1 - L])
        atomicAdd(S.put(kCountB), s_len[1 - L]);
      S.sync();
      const int n_same = S.got(kCountB);
      const int len_same = s_len[1 - L];
      // backward membership inside each colour class, all roots at once
      k = 0;
      changed = 1;
      if (n_same == 0) {
        k = 1;  // a sweep over no edge, counted without a pass
        changed = 0;
      } else {
        while (changed && k < a.sweep_cap) {
          ++k;
          ++g;
          sweep_list(S, a, sd, ss, len_same, a.m[(k - 1) & 1], a.m[k & 1], g,
                     k == 1);
          S.sync();
          changed = S.got(kChanged);
        }
      }
      const int ok_b = !changed;
      sweeps += k;
      const int* m = a.m[k & 1];
      ok = ok && ok_f && ok_b;
      ++rounds;
      const bool more = ok && rounds < a.round_cap;
      // retire the members; when another round may follow, list its live
      // edges (those of this round whose ends both stay) and set its
      // colours
      if (threadIdx.x == 0) s_len[1 - L] = 0;
      __syncthreads();
      int mine = 0;
      for (int v = S.tid; v < n; v += S.stride) {
        if (a.active[v]) {
          if (m[v] > 0) {
            a.out[v] = c[v];
            a.active[v] = 0;
          } else {
            mine = 1;
            if (more) a.c[0][v] = a.c[1][v] = v;
          }
        }
      }
      raise_any(mine, S.lane, S.put(kAny));
      if (more) {
        filter_list(
            S, fs, fd, len_live,
            [m](int s, int t) { return m[s] == 0 && m[t] == 0; },
            &s_len[1 - L], ss, sd);
      }
      __syncthreads();
      if (more && threadIdx.x == 0 && s_len[1 - L])
        atomicAdd(S.put(kCountA), s_len[1 - L]);
      if (!ok) break;  // the tail says not ok whatever stays active
      S.sync();
      any_active = S.got(kAny);
      if (!more || !any_active) break;
      L = 1 - L;
      n_live = S.got(kCountA);
      len_live = s_len[L];
    }
  }
  if (S.tid == 0) {
    a.out[n] = (ok && !any_active) ? 1 : 0;
    a.out[n + 1] = rounds;
    a.out[n + 2] = sweeps;
    if (a.syncs) {
      a.syncs[0] = S.grid_syncs;
      a.syncs[1] = S.block_syncs;
    }
  }
}

// ---------------------------------------------------------------------
// The convergence launch.
//
// scc_converge_kernel labels every node with no caps (ok is always 1).
// It is not bound to the reference's sweep counts, only to its labels,
// so it may do less work than the peeling loop:
//   - It builds the live edges (edge_on, self-loops dropped: they never
//     join two nodes) into CSR forms by source and by target: degree
//     counts, an exclusive scan over the blocks' chunks, a fill.
//   - Trim. A node with no live in-edge or no live out-edge is its own
//     component: it retires with its own id, and each of its edges
//     lowers a neighbour's degree counter; a neighbour whose counter
//     reaches 0 joins the next pass's frontier (claimed once, by a
//     compare-and-swap of its state). Passes are level-synchronous, so
//     the set each pass retires, and the number of passes, do not
//     depend on the order of the atomics. A DAG, such as a decreasing
//     chain, is retired by trim alone, in (longest path + 1) / 2 passes
//     of work proportional to the frontier.
//   - Colouring rounds on what trim leaves: forward and backward Jacobi
//     fixpoints as in the capped launch, but driven by a frontier list of
//     the nodes that changed in the previous sweep and their CSR rows, so
//     a sweep costs what changed, not E. A round's members retire and
//     lower their neighbours' counters, which may start another trim.
//   - The first round colours by id, later rounds by priority. Where
//     ids follow a topological order, as in a wide graph of clusters
//     joined by forward edges, the round by id retires most components
//     at once (the wide case of chip_smoke's phase 7b: 1 round; by
//     priority alone: 11). Coloured by id, a decreasing chain of k
//     non-trivial cycles (which trim cannot touch) would take k rounds,
//     each a flood down the rest of the chain that retires one cycle:
//     k(k + 19) sweeps for k ten-node cycles; and even its first round
//     costs O(k) frontier nodes a sweep for ~2k sweeps, as every cycle's
//     id floods down until a higher one overtakes it (k = 2,000: 174 ms
//     on the H100 against 21 ms without it). So the round by id gives up
//     with no member once kFirstRoundSweeps forward sweeps have not
//     settled it, and the launch goes on by priority. A later round
//     gives node v the colour prio(v) = v * kPrio mod 2^31, a bijection
//     of the ids (kPrio is odd) that looks random along a run of ids; a
//     root is a node whose colour is its own id (first round) or
//     priority (later). Every cycle whose priority beats those of all
//     the active cycles above it retires in the same round, and the
//     retired cycles cut the chain into pieces that flood on their own:
//     8 rounds and 705 sweeps for k = 100, 10 and 2,378 for k = 800.
//   - Labels. A member retires holding its root's id (its colour in the
//     first round, unprio(colour) after it) and raises that root's slot
//     of `top` to its own id; a trimmed node is its own root. One pass
//     after the last round sets each label to its root's slot, the max
//     member id of the component, as scipy's labels are. It needs no
//     sync of its own: the listing pass that finds no active node ends
//     with one, after every retirement.
//   - The one-block tail. The work left (nodes and CSR entries not yet
//     retired) is counted from the slots after each sync; once it falls
//     to tail_work, every block but block 0 leaves at the same sync, and
//     block 0 finishes with __syncthreads only.
// Its counts (rounds, sweeps, trim passes) are order-free, since the
// colours of each round are fixed, so its plain version
// (gpu/kernels/scc.py) mirrors them exactly. What the colouring still
// costs: a round floods each piece of a chain from its top, so the sweeps
// of a round are the longest piece's length; a first round that gives up
// costs kFirstRoundSweeps sweeps; and a single cycle of L nodes still
// takes 2L sweeps.

enum { kActive = 0, kQueued = 1, kRetired = 2 };

// prio(v) = v * kPrio mod 2^31 and its inverse, in unsigned arithmetic
// (kPrioInv * kPrio = 1 mod 2^32), and the forward sweeps after which the
// first round, by id, gives up; gpu/kernels/scc.py holds the same
// constants.
constexpr unsigned kPrio = 0x9E3779B1u, kPrioInv = 0x0E8B2F51u;
constexpr unsigned kPrioMask = 0x7fffffffu;
constexpr int kFirstRoundSweeps = 64;

__device__ __forceinline__ int prio(int v) {
  return (int)(((unsigned)v * kPrio) & kPrioMask);
}

__device__ __forceinline__ int unprio(int x) {
  return (int)(((unsigned)x * kPrioInv) & kPrioMask);
}

struct Conv {
  const int* src;
  const int* dst;
  const uint8_t* edge_on;
  int n, e, tail_work;
  int* state;  // [n]
  int* c[2];
  int* m[2];
  int* stamp;
  int* top;      // [n] the max member id of each root's component
  int* cnt_out;  // [n] degree counts, then fill cursors
  int* cnt_in;
  int* outdeg;  // [n] live degree counters for trim
  int* indeg;
  int* out_off;  // [n + 1]
  int* in_off;
  int* out_adj;  // [e]
  int* in_adj;
  int* act[2];  // [n] active-node lists
  int* fr[2];   // [n] frontiers
  int* bsum;    // [2 * kMaxBlocks]
  int* ctl;
  int* out;    // [n + 4]: roots, at the end labels; ok, rounds, sweeps,
               // trim passes
  int* syncs;  // optional [2]: grid syncs, tail barriers
};

// Sum over the block, returned to every thread. Every thread must call.
__device__ int block_sum(int x) {
  __shared__ int part[32];
  __shared__ int total;
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // part and total may still be read by a previous call
  if (lane == 0) part[w] = x;
  __syncthreads();
  if (w == 0) {
    int y = lane < (int)(blockDim.x >> 5) ? part[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      y += __shfl_xor_sync(kFull, y, off);
    if (lane == 0) total = y;
  }
  __syncthreads();
  return total;
}

// Inclusive scan over the block; *sum gets the block's total. Every
// thread must call.
__device__ int block_scan(int x, int* sum) {
  __shared__ int part[32];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  __syncthreads();
  if (lane == 31) part[w] = x;
  __syncthreads();
  if (w == 0) {
    int y = lane < (int)(blockDim.x >> 5) ? part[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int z = __shfl_up_sync(kFull, y, off);
      if (lane >= off) y += z;
    }
    part[lane] = y;  // inclusive prefix of the warp totals
  }
  __syncthreads();
  if (w > 0) x += part[w - 1];
  *sum = part[(blockDim.x >> 5) - 1];
  return x;
}

// Claims node w for the frontier `list` (count in *count) unless it was
// claimed or retired already.
__device__ __forceinline__ void claim(const Conv& a, int w, int* list,
                                      int* count) {
  if (atomicCAS(&a.state[w], kActive, kQueued) == kActive)
    list[atomicAdd(count, 1)] = w;
}

// Retires v (the root of its component: root) and lowers its neighbours'
// counters; a neighbour left with no live in- or out-edge is claimed for
// `list`, unless it is a member retiring in the same pass (mfin[w] != 0;
// mfin null in trim). Returns the work retired: the node and its CSR
// entries.
__device__ __forceinline__ int retire(const Conv& a, int v, int root,
                                      const int* mfin, int* list,
                                      int* count) {
  a.out[v] = root;
  atomicMax(&a.top[root], v);
  a.state[v] = kRetired;
  const int o0 = a.out_off[v], o1 = a.out_off[v + 1];
  const int i0 = a.in_off[v], i1 = a.in_off[v + 1];
  for (int k = o0; k < o1; ++k) {
    const int w = a.out_adj[k];
    if (atomicSub(&a.indeg[w], 1) == 1 && (!mfin || !mfin[w])) {
      if (a.state[w] == kActive) claim(a, w, list, count);
    }
  }
  for (int k = i0; k < i1; ++k) {
    const int u = a.in_adj[k];
    if (atomicSub(&a.outdeg[u], 1) == 1 && (!mfin || !mfin[u])) {
      if (a.state[u] == kActive) claim(a, u, list, count);
    }
  }
  return 1 + (o1 - o0) + (i1 - i0);
}

__device__ __forceinline__ void add_work(Sync& S, int work) {
  for (int off = 16; off > 0; off >>= 1)
    work += __shfl_xor_sync(kFull, work, off);
  if (S.lane == 0 && work) atomicAdd(S.put(kWork), work);
}

__global__ void __launch_bounds__(kThreads, 1) scc_converge_kernel(Conv a) {
  Sync S = make_sync(a.ctl);
  const int n = a.n;
  int rounds = 0, sweeps = 0, passes = 0, g = 0;
  if (n > 0) {
    // 1. set up, count degrees
    for (int v = S.tid; v < n; v += S.stride) {
      a.cnt_out[v] = a.cnt_in[v] = 0;
      a.state[v] = kActive;
      a.stamp[v] = 0;
      a.top[v] = -1;
    }
    if (S.tid == 0)
      for (int i = 0; i < 3 * kSlot; ++i) a.ctl[i] = 0;
    S.sync();
    for (int i = S.tid; i < a.e; i += S.stride) {
      const int s = __ldg(a.src + i), t = __ldg(a.dst + i);
      if (__ldg(a.edge_on + i) && s != t) {
        atomicAdd(&a.cnt_out[s], 1);
        atomicAdd(&a.cnt_in[t], 1);
      }
    }
    S.sync();
    // 2. exclusive scan of the counts: each block sums its chunk, then
    // scans it from the sum of the chunks before it
    const int blocks = gridDim.x, b = blockIdx.x;
    const int chunk = (n + blocks - 1) / blocks;
    const int lo = min(n, b * chunk), hi = min(n, lo + chunk);
    {
      int so = 0, si = 0;
      for (int v = lo + threadIdx.x; v < hi; v += blockDim.x) {
        so += a.cnt_out[v];
        si += a.cnt_in[v];
      }
      so = block_sum(so);
      si = block_sum(si);
      if (threadIdx.x == 0) {
        a.bsum[b] = so;
        a.bsum[kMaxBlocks + b] = si;
      }
    }
    S.sync();
    {
      int po = 0, pi = 0;
      for (int k = threadIdx.x; k < b; k += blockDim.x) {
        po += a.bsum[k];
        pi += a.bsum[kMaxBlocks + k];
      }
      po = block_sum(po);
      pi = block_sum(pi);
      for (int base = lo; base < hi; base += blockDim.x) {
        const int v = base + threadIdx.x;
        const int xo = v < hi ? a.cnt_out[v] : 0;
        const int xi = v < hi ? a.cnt_in[v] : 0;
        int to, ti;
        const int io = block_scan(xo, &to);
        const int ii = block_scan(xi, &ti);
        if (v < hi) {
          a.out_off[v] = po + io - xo;
          a.in_off[v] = pi + ii - xi;
        }
        po += to;
        pi += ti;
      }
      if (b == blocks - 1 && threadIdx.x == 0) {
        a.out_off[n] = po;
        a.in_off[n] = pi;
      }
    }
    S.sync();
    // 3. fill the CSR rows; set the degree counters; the nodes with no
    // live in- or out-edge are the first trim frontier
    for (int i = S.tid; i < a.e; i += S.stride) {
      const int s = __ldg(a.src + i), t = __ldg(a.dst + i);
      if (__ldg(a.edge_on + i) && s != t) {
        a.out_adj[a.out_off[s] + atomicSub(&a.cnt_out[s], 1) - 1] = t;
        a.in_adj[a.in_off[t] + atomicSub(&a.cnt_in[t], 1) - 1] = s;
      }
    }
    for (int bb = S.tid - S.lane; bb < n; bb += S.stride) {
      const int v = bb + S.lane;
      bool z = false;
      if (v < n) {
        const int dout = a.out_off[v + 1] - a.out_off[v];
        const int din = a.in_off[v + 1] - a.in_off[v];
        a.outdeg[v] = dout;
        a.indeg[v] = din;
        z = dout == 0 || din == 0;
        if (z) a.state[v] = kQueued;
      }
      append(z, S.lane, S.put(kCountA), a.fr[0], v);
    }
    S.sync();
    int n_trim = S.got(kCountA);
    long long rem = (long long)n + 2LL * a.out_off[n];
    // every block but block 0 leaves once the work left is small
    auto leave = [&]() -> bool {
      if (S.tail || rem > a.tail_work) return false;
      if (blockIdx.x != 0) return true;
      S.tail = true;
      S.tid = threadIdx.x;
      S.stride = blockDim.x;
      return false;
    };
    if (leave()) return;
    int p = 0;      // the trim frontier is fr[p]
    int A = 0;      // the active list is act[A]
    int n_act = n;  // round 1: every node, unlisted
    bool listed = false;
    bool first = true;  // the first round colours by id
    while (true) {
      // 4. trim to a fixpoint
      while (n_trim > 0) {
        ++passes;
        int work = 0;
        for (int bb = S.tid - S.lane; bb < n_trim; bb += S.stride) {
          const int i = bb + S.lane;
          if (i < n_trim) {
            const int v = a.fr[p][i];
            work += retire(a, v, v, nullptr, a.fr[1 - p], S.put(kCountA));
          }
        }
        add_work(S, work);
        S.sync();
        n_trim = S.got(kCountA);
        rem -= S.got(kWork);
        p = 1 - p;
        if (leave()) return;
      }
      // 5. list the nodes trim left, and set their colours: ids in the
      // first round, priorities after it
      const bool by_id = first;
      for (int bb = S.tid - S.lane; bb < n_act; bb += S.stride) {
        const int i = bb + S.lane;
        int v = 0;
        bool keep = false;
        if (i < n_act) {
          v = listed ? a.act[A][i] : i;
          keep = a.state[v] == kActive;
          if (keep) a.c[0][v] = a.c[1][v] = by_id ? v : prio(v);
        }
        append(keep, S.lane, S.put(kCountB), a.act[1 - A], v);
      }
      S.sync();
      n_act = S.got(kCountB);
      A = 1 - A;
      listed = true;
      if (leave()) return;
      if (n_act == 0) break;
      const int* act = a.act[A];
      // 6. forward colours, each sweep over the CSR rows of the nodes
      // that changed in the one before (the first: every listed node)
      int k = 0, q = 0, n_f = n_act;
      const int* fr = act;
      while (n_f > 0 && !(by_id && k == kFirstRoundSweeps)) {
        ++k;
        ++g;
        const int* xr = a.c[(k - 1) & 1];
        int* xw = a.c[k & 1];
        int* next = a.fr[q];
        int* cnt = S.put(kCountA);
        for (int i = S.tid; i < n_f; i += S.stride) {
          const int u = fr[i];
          const int vu = xr[u];
          if (k > 1) atomicMax(&xw[u], vu);
          const int o1 = a.out_off[u + 1];
          for (int o = a.out_off[u]; o < o1; ++o) {
            const int w = a.out_adj[o];
            if (a.state[w] == kActive && vu > xr[w]) {
              atomicMax(&xw[w], vu);
              if (atomicExch(&a.stamp[w], g) != g) next[atomicAdd(cnt, 1)] = w;
            }
          }
        }
        S.sync();
        n_f = S.got(kCountA);
        fr = next;
        q = 1 - q;
        if (leave()) return;
      }
      sweeps += k;
      first = false;
      // the round by id gave up: colour by priority from here
      if (n_f > 0) continue;
      const int* c = a.c[k & 1];
      // 7. the roots seed membership
      for (int bb = S.tid - S.lane; bb < n_act; bb += S.stride) {
        const int i = bb + S.lane;
        bool root = false;
        int v = 0;
        if (i < n_act) {
          v = act[i];
          root = c[v] == (by_id ? v : prio(v));
          a.m[0][v] = a.m[1][v] = root ? 1 : 0;
        }
        append(root, S.lane, S.put(kCountA), a.fr[0], v);
      }
      S.sync();
      n_f = S.got(kCountA);
      fr = a.fr[0];
      q = 1;
      if (leave()) return;
      // 8. backward membership over the CSR rows by target, inside each
      // colour class
      k = 0;
      while (n_f > 0) {
        ++k;
        ++g;
        const int* mr = a.m[(k - 1) & 1];
        int* mw = a.m[k & 1];
        int* next = a.fr[q];
        int* cnt = S.put(kCountA);
        for (int i = S.tid; i < n_f; i += S.stride) {
          const int v = fr[i];
          if (k > 1) mw[v] = 1;
          const int cv = c[v];
          const int i1 = a.in_off[v + 1];
          for (int o = a.in_off[v]; o < i1; ++o) {
            const int u = a.in_adj[o];
            if (a.state[u] == kActive && mr[u] == 0 && c[u] == cv) {
              mw[u] = 1;
              if (atomicExch(&a.stamp[u], g) != g) next[atomicAdd(cnt, 1)] = u;
            }
          }
        }
        S.sync();
        n_f = S.got(kCountA);
        fr = next;
        q = 1 - q;
        if (leave()) return;
      }
      sweeps += k;
      const int* m = a.m[k & 1];
      ++rounds;
      // 9. retire the members; neighbours they leave with no live in- or
      // out-edge start the next trim
      {
        int work = 0;
        for (int bb = S.tid - S.lane; bb < n_act; bb += S.stride) {
          const int i = bb + S.lane;
          if (i < n_act) {
            const int v = act[i];
            if (m[v])
              work += retire(a, v, by_id ? c[v] : unprio(c[v]), m, a.fr[0],
                             S.put(kCountA));
          }
        }
        add_work(S, work);
      }
      S.sync();
      n_trim = S.got(kCountA);
      rem -= S.got(kWork);
      p = 0;
      if (leave()) return;
    }
    // 10. labels: every node retired before step 5's last sync
    for (int v = S.tid; v < n; v += S.stride) a.out[v] = a.top[a.out[v]];
  }
  if (S.tid == 0) {
    a.out[n] = 1;
    a.out[n + 1] = rounds;
    a.out[n + 2] = sweeps;
    a.out[n + 3] = passes;
    if (a.syncs) {
      a.syncs[0] = S.grid_syncs;
      a.syncs[1] = S.block_syncs;
    }
  }
}

// ---------------------------------------------------------------------
// Launch helpers.

// Blocks of a cooperative grid for `work` items: as many as can be
// resident at once (asked of the CUDA runtime once per device and
// kernel, and kept), and no more than the work needs.
int grid_blocks(const void* kernel, int which, int dev, long long work) {
  constexpr int kDevices = 64;
  static int resident[2][kDevices];  // 0 until asked; a race asks twice
  if (dev < 0 || dev >= kDevices) return -1;
  if (resident[which][dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0) !=
        cudaSuccess)
      return -1;
    resident[which][dev] = per_sm * sms;
  }
  long long want = (work + kThreads - 1) / kThreads;
  if (want < 1) want = 1;
  long long most = resident[which][dev];
  if (most > kMaxBlocks) most = kMaxBlocks;
  return (int)(want < most ? want : most);
}

int check_device(int* dev) {
  int supported = 0;
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&supported, cudaDevAttrCooperativeLaunch, *dev);
  if (err != cudaSuccess) return (int)err;
  return supported ? 0 : (int)cudaErrorNotSupported;
}

int launch(const void* kernel, int blocks, void* args, void* stream) {
  if (blocks < 1) {
    cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidDevice);
  }
  void* params[] = {args};
  cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(kThreads), params, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Carves 16-byte-aligned arrays out of one scratch buffer.
struct Carve {
  char* at;
  size_t used;
  template <typename T>
  T* take(long long count) {
    const size_t bytes = ((size_t)(count > 0 ? count : 1) * sizeof(T) + 15) &
                         ~(size_t)15;
    T* p = at ? (T*)(at + used) : nullptr;
    used += bytes;
    return p;
  }
};

void carve_capped(Capped& a, Carve& cv) {
  a.active = cv.take<uint8_t>(a.n);
  for (int i = 0; i < 2; ++i) {
    a.c[i] = cv.take<int>(a.n);
    a.m[i] = cv.take<int>(a.n);
    a.stamp[i] = cv.take<int>(a.n);
    a.ls[i] = cv.take<int>((long long)a.e + kMaxBlocks);
    a.ld[i] = cv.take<int>((long long)a.e + kMaxBlocks);
  }
  a.block_flag = cv.take<int>(kMaxBlocks);
  a.ctl = cv.take<int>(3 * kSlot);
}

void carve_conv(Conv& a, Carve& cv) {
  a.state = cv.take<int>(a.n);
  for (int i = 0; i < 2; ++i) {
    a.c[i] = cv.take<int>(a.n);
    a.m[i] = cv.take<int>(a.n);
    a.act[i] = cv.take<int>(a.n);
    a.fr[i] = cv.take<int>(a.n);
  }
  a.stamp = cv.take<int>(a.n);
  a.top = cv.take<int>(a.n);
  a.cnt_out = cv.take<int>(a.n);
  a.cnt_in = cv.take<int>(a.n);
  a.outdeg = cv.take<int>(a.n);
  a.indeg = cv.take<int>(a.n);
  a.out_off = cv.take<int>((long long)a.n + 1);
  a.in_off = cv.take<int>((long long)a.n + 1);
  a.out_adj = cv.take<int>(a.e);
  a.in_adj = cv.take<int>(a.e);
  a.bsum = cv.take<int>(2 * kMaxBlocks);
  a.ctl = cv.take<int>(3 * kSlot);
}

bool bad_size(int n, int e) { return n < 0 || e < 0 || e > kMaxEdges; }

}  // namespace

extern "C" {

// Bytes of uninitialised device scratch that scc_launch needs.
long long scc_scratch_bytes(int n, int e) {
  Capped a{};
  a.n = n;
  a.e = e;
  Carve cv{nullptr, 0};
  carve_capped(a, cv);
  return (long long)cv.used;
}

// Launches the capped peeling loop on `stream`. out int32 [n + 3];
// syncs, when not null, int32 [2] (grid syncs, tail barriers). Returns
// the CUDA error code of the launch (0 = launched).
int scc_launch(const int* src, const int* dst, const uint8_t* edge_on, int n,
               int e, int sweep_cap, int round_cap, void* scratch, int* out,
               int* syncs, void* stream) {
  if (bad_size(n, e) || sweep_cap < 0 || round_cap < 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  int err = check_device(&dev);
  if (err) return err;
  Capped a{};
  a.src = src;
  a.dst = dst;
  a.edge_on = edge_on;
  a.n = n;
  a.e = e;
  a.sweep_cap = sweep_cap;
  a.round_cap = round_cap;
  a.out = out;
  a.syncs = syncs;
  Carve cv{(char*)scratch, 0};
  carve_capped(a, cv);
  const int blocks = grid_blocks((const void*)scc_kernel, 0, dev,
                                 n > e ? n : e);
  return launch((const void*)scc_kernel, blocks, &a, stream);
}

// Bytes of uninitialised device scratch that scc_converge_launch needs.
long long scc_converge_scratch_bytes(int n, int e) {
  Conv a{};
  a.n = n;
  a.e = e;
  Carve cv{nullptr, 0};
  carve_conv(a, cv);
  return (long long)cv.used;
}

// Launches the convergence kernel on `stream`. out int32 [n + 4]; syncs
// as for scc_launch. tail_work: the work left (nodes plus CSR entries)
// at which block 0 goes on alone (negative: never).
int scc_converge_launch(const int* src, const int* dst,
                        const uint8_t* edge_on, int n, int e, int tail_work,
                        void* scratch, int* out, int* syncs, void* stream) {
  if (bad_size(n, e)) return (int)cudaErrorInvalidValue;
  int dev = 0;
  int err = check_device(&dev);
  if (err) return err;
  Conv a{};
  a.src = src;
  a.dst = dst;
  a.edge_on = edge_on;
  a.n = n;
  a.e = e;
  a.tail_work = tail_work;
  a.out = out;
  a.syncs = syncs;
  Carve cv{(char*)scratch, 0};
  carve_conv(a, cv);
  const int blocks = grid_blocks((const void*)scc_converge_kernel, 1, dev,
                                 n > e ? n : e);
  return launch((const void*)scc_converge_kernel, blocks, &a, stream);
}

const char* scc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
