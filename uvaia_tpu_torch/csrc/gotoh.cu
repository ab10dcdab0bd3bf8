// Banded affine Gotoh forward: the hand-written Hopper kernels that
// replace uvaia_tpu/ops/pallas_gotoh.py:_fwd_kernel (traceback bytes,
// EmitTb = true) and pallas_gotoh.py:_score_kernel (score only).
//
// What they compute is uvaia_tpu/ops/gotoh.py:_row_kernel, cell for cell:
// cost model match 0, mismatch 4, gap of length g 6 + 2g; band slot t of
// DP row i (reference char i-1) is query column j = i + lo + t.  Per row,
// from the previous row's H and X:
//   m = H'[t] + sub(q[j-1], ref[i-1])         (INF unless 1 <= j <= qlen)
//   x = min(H'[t+1] + 8, X'[t+1] + 2)          (slot W reads INF)
//   g = min(m, x)
//   y = min(8 + (t-1)*2 + min_{s<t}(g[s] - 2s), INF), y[0] = INF
//   H = min(min(g, y), INF), X = min(x, INF)   (INF outside 0 <= j <= qlen)
//   tb = src | x_from_ext<<2 | y_from_ext<<3 | g_from_x<<4
// with the JAX tie rules (extend wins an X tie, open wins a Y tie,
// g_from_x compares the masked X with m) and the running band-edge
// minimum over H[0] and H[W-1].  Keeping every int32 saturation point of
// _row_kernel makes a kernel equal its plain version at every cell.
//
// What bounds it on the H100: not bytes and not operations but a serial
// chain.  Row i needs row i-1, and inside a row y needs a prefix minimum
// over the whole band, so the n rows are n dependent steps of about
// 5 + log2(W) dependent integer instructions each, whatever the number
// of lanes.  Below that floor, a row costs what one warp takes to run
// it: a sub-partition of the SM has 16 int32 lanes, so a warp starts an
// integer instruction every second clock, and a shuffle round trip is
// ~25 clocks.  The design keeps everything it can off that chain and
// counts instructions.
//
// Register kernel (gotoh_reg_kernel, W <= 4,352).  A query row belongs to
// one warp (W <= 544) or to a CTA of up to 8 warps.  Thread k owns the S
// contiguous slots [k*S, (k+1)*S) and keeps their H, X and query bytes in
// registers from row to row; slots past W-1 hold INF and are never
// written out.  Per row:
//   * every cell is computed once: m, x, the X tie flag and g stay in
//     registers from the fold (min of g - 2t over the thread's slots, a
//     tree; the exclusive prefix inside the thread is only needed after
//     the scan) to the finish;
//   * the t+1 neighbour of a thread's last slot is one shuffle each for
//     H and X; the exclusive prefix minimum over the lanes is a radix-4
//     shuffle scan, three dependent rounds instead of five;
//   * no memory read is on the chain: slot t of row i compares query byte
//     q[i+lo+t-1], which slot t-1 needs on row i+1, so the bytes shift
//     down one slot a row (one shuffle) and a fresh byte enters at the
//     warp's last slot; the fresh bytes and the reference bytes (the same
//     for every slot) are loaded 32 rows at a time, one block ahead, one
//     byte a lane, and handed out by a shuffle started a row early;
//   * what does not change from row to row is a mask applied with max()
//     (pad slots, the lanes a shuffle wraps around, slot 0's y), and the
//     rows whose whole band lies inside the query (all but the first and
//     last ~W) run a body without the column tests;
//   * the traceback bytes are staged in shared memory and leave one row
//     late as aligned 16-byte stores (plus the ragged ends, a byte a
//     lane): W = 129 bytes at an odd address stored a byte a lane cost
//     more than the recurrence;
//   * one warp a row: the row loop has no barrier.  Several warps a row:
//     one barrier a row.  The last slot of a warp needs H and X of the
//     next warp's first slot, and the later warps need this warp's fold;
//     both would cost a barrier each.  Instead the next warp's first lane
//     computes that slot's x from its own registers and publishes it, the
//     warp publishes its fold with that x left out (INF), and after the
//     one barrier every warp corrects the published folds (min with
//     x - 2t) before it takes the prefix over the warps below it (one
//     redux).  The values are double buffered by row parity, so a warp
//     one row ahead never overwrites what a slower warp still reads.
// Rows run side by side: B CTAs, spread over the 132 SMs by the hardware.
//
// Wide kernel (gotoh_wide_kernel, W > 4,352: certificate-2 bands).  One
// CTA a row, the previous H and X rows double buffered in shared memory
// while 16*W bytes fit (W <= 14,464), else in a (B, 4, W) device-memory
// scratch buffer the wrapper allocates; two passes over a thread's slots
// around a block prefix minimum, three barriers a row.
//
// The traceback write is B*n*W bytes (3.9 GB for a pool of 1,024 at
// n = 29,903, W = 129: 1.2 ms at 3.35 TB/s).  The Pallas kernel's
// super-window read, lane roll and 128-row grid chunks existed only for
// Mosaic.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kInf = 1 << 28;
constexpr int kMismatch = 4;
constexpr int kGapOpen = 6;
constexpr int kGapExt = 2;
constexpr int kOE = kGapOpen + kGapExt;
constexpr unsigned kFull = 0xffffffffu;

// ----------------------------------------------------------------------
// the register kernel

constexpr int kRegMaxWarps = 8;

// INT_MIN on the lanes from d up, INT_MAX below: max(v, mask) keeps a
// value shuffled up by d and turns the wrapped-around ones into INT_MAX
__device__ __forceinline__ int up_mask(int lane, int d) {
  return lane >= d ? INT_MIN : INT_MAX;
}

__device__ __forceinline__ int shfl_up(int v, int d) {
  return __shfl_up_sync(kFull, v, d);
}

// keeps a loop-invariant value in its register: without it the compiler
// works the value out again in every row instead of holding it
__device__ __forceinline__ void hold(int& v) { asm volatile("" : "+r"(v)); }

// a + b where the sum may wrap (its result is then masked away)
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// shared memory by its 32-bit address: the compiler re-derives a shared
// array's address from special registers at every use in the row loop
__device__ __forceinline__ void sts8(uint32_t addr, int v) {
  asm volatile("st.shared.u8 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ int lds8(uint32_t addr) {
  int v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Staged bytes [d, end) leave as the 16-byte chunks inside them plus a
// ragged head (below byte 16, when d > 0) and tail (from end & ~15): the
// byte this lane stores of those, lanes 0-15 the head and 16-31 the tail,
// or -1.
__device__ __forceinline__ int ragged_byte(int lane, int d, int end) {
  if (lane < 16) {
    const int e = d + lane;
    return d > 0 && e < min(16, end) ? e : -1;
  }
  const int e = (end & ~15) + lane - 16;
  return (e >= 16 || d == 0) && e < end ? e : -1;
}

template <int S, bool kMulti, bool EmitTb>
__global__ void __launch_bounds__(kMulti ? 32 * kRegMaxWarps : 32)
gotoh_reg_kernel(const uint8_t* __restrict__ ref, int n,
                 const uint8_t* __restrict__ q, int m_pad,
                 const int* __restrict__ qlens, int lo, int W, int B,
                 uint8_t* __restrict__ tb, int* __restrict__ score_out,
                 int* __restrict__ tend_out, int* __restrict__ edge_out) {
  // per row parity: each warp's fold (its last slot's x left out), the g
  // of its last slot (likewise) and, from the first lane of the warp
  // above, that slot's x << 1 | tie flag
  __shared__ int sh_fold[2][kRegMaxWarps], sh_g[2][kRegMaxWarps],
      sh_x[2][kRegMaxWarps];
  __shared__ int sh_edge;
  // per warp and row parity: a row's traceback bytes, staged at the
  // 16-byte phase of their place in tb
  constexpr int kStage = EmitTb ? 32 * S + 32 : 16;
  constexpr int kStageIters = (kStage / 16 + 31) / 32;
  __shared__ __align__(16) uint8_t
      sh_tb[EmitTb && kMulti ? kRegMaxWarps : 1][2][kStage];
  const int lane = threadIdx.x & 31;
  const int warp = kMulti ? threadIdx.x >> 5 : 0;
  const int nw = kMulti ? blockDim.x >> 5 : 1;
  const int b = blockIdx.x;
  const int qlen = qlens[b];
  const uint8_t* qrow = q + static_cast<size_t>(b) * m_pad;
  const int t0 = (warp * 32 + lane) * S;        // this thread's first slot
  const int seg0 = warp * 32 * S;               // this warp's first slot,
  const int seg_len = max(0, min(W - seg0, 32 * S));   // its real slots
  const int t_last = seg0 + 32 * S - 1;         // and its last slot
  const bool top = lane == 31;
  const bool deferred = kMulti && top && warp < nw - 1;

  // Loop-invariant masks, applied with max(): INT_MIN lets a value
  // through, INF (or INT_MAX) replaces it.
  int pad[S];                                   // slots past the band
  int first = t0 == 0 ? kInf : INT_MIN;         // y of slot 0
  int up1 = up_mask(lane, 1), up2 = up_mask(lane, 2), up3 = up_mask(lane, 3),
      up4 = up_mask(lane, 4), up8 = up_mask(lane, 8),
      up12 = up_mask(lane, 12), up16 = up_mask(lane, 16);
  hold(first), hold(up1), hold(up2), hold(up3), hold(up4), hold(up8),
      hold(up12), hold(up16);

  int H[S], X[S], qc[S], low[S];                // low: running min of H
#pragma unroll
  for (int s = 0; s < S; ++s) {                 // row 0
    const int t = t0 + s, j0 = t + lo;
    const int h = j0 == 0 ? 0 : (j0 > 0 ? kGapOpen + kGapExt * j0 : kInf);
    pad[s] = t < W ? INT_MIN : kInf;
    hold(pad[s]);
    H[s] = (j0 > qlen || t >= W) ? kInf : h;
    X[s] = kInf;
    low[s] = H[s];
    qc[s] = (j0 >= 0 && j0 < m_pad) ? qrow[j0] : 0;   // q[j-1] of row 1
  }

  // rows i0 + lane: the reference byte of the row, and << 8 the query
  // byte that enters at the warp's last slot after it
  auto fetch = [&](int i0) {
    const int i = i0 + lane;
    const int r = i <= n ? ref[i - 1] : 0;
    const int k = i + lo + t_last;
    const int f = (k >= 0 && k < m_pad) ? qrow[k] : 0;
    return r | (f << 8);
  };

  // The traceback bytes of a row leave one row late: the warp's part of
  // row i (slots [seg0, seg0 + seg_len)) is staged in shared memory at
  // byte (address & 15) + slot, read back at the top of row i + 1 as
  // 16-byte chunks (lane c: chunk c) plus one byte a lane of the ragged
  // head and tail, and stored after that row's cells, so neither the
  // shared-memory reads nor the stores wait.  Which chunks and which
  // ragged byte a lane moves depends on the row's phase alone, and the
  // phase is the same for every row when B * W is a multiple of 16 (the
  // engine's batches are multiples of 64): they are worked out again
  // only when the phase changes.
  uint8_t* row_tb =                             // the warp's part of row i
      EmitTb ? tb + static_cast<size_t>(b) * W + seg0 : nullptr;
  const size_t row_step = static_cast<size_t>(B) * W;
  uint32_t stage =
      static_cast<uint32_t>(__cvta_generic_to_shared(&sh_tb[warp][0][0]));
  asm volatile("" : "+r"(stage));   // one register, not re-derived per use
  uint4 out16[kStageIters];
  int out1 = 0;
  int phase = -1, ragged = -1;                  // of the row being moved
  bool whole[kStageIters];                      // this lane's chunks inside it
#pragma unroll
  for (int k = 0; k < kStageIters; ++k) whole[k] = false;
  auto set_phase = [&](int d) {
    phase = d;
    const int end = d + seg_len;
#pragma unroll
    for (int k = 0; k < kStageIters; ++k) {
      const int c = 16 * (lane + 32 * k);
      whole[k] = c >= d && c + 16 <= end;
    }
    ragged = ragged_byte(lane, d, end);
  };
  auto stage_load = [&](uint32_t st, int d) {
    if (d != phase) set_phase(d);
#pragma unroll
    for (int k = 0; k < kStageIters; ++k)
      if (whole[k]) out16[k] = lds128(st + 16 * (lane + 32 * k));
    if (ragged >= 0) out1 = lds8(st + ragged);
  };
  auto stage_store = [&](uint8_t* a) {          // after stage_load of the row
    a -= phase;
#pragma unroll
    for (int k = 0; k < kStageIters; ++k)
      if (whole[k])
        *reinterpret_cast<uint4*>(a + 16 * (lane + 32 * k)) = out16[k];
    if (ragged >= 0) a[ragged] = static_cast<uint8_t>(out1);
  };

  int d_prev = 0;
  // One DP row.  kInside: every slot of the band has 1 <= j <= qlen, so
  // the column tests are left out (all but the first and last rows).
  auto row = [&](auto inside, int i, int fed) {
    constexpr bool kInside = decltype(inside)::value;
    const int buf = i & 1;
    const int refc = fed & 0xff;
    const int d = static_cast<int>(reinterpret_cast<uintptr_t>(row_tb) & 15);
    if (EmitTb && i > 1) stage_load(stage + (buf ^ 1) * kStage, d_prev);

    // H and X of slot t + 1: the next lane's first slot; past the warp
    // INF (a later warp's x comes through shared memory below)
    int hn = __shfl_down_sync(kFull, H[0], 1);
    int xn = __shfl_down_sync(kFull, X[0], 1);
    if (top) hn = xn = kInf;
    if (kMulti && lane == 0 && warp > 0) {
      const int xo = H[0] + kOE, xe = X[0] + kGapExt;
      sh_x[buf][warp - 1] = (min(xo, xe) << 1) | (xe <= xo);
    }

    const int jb = i + lo + t0;                 // column of slot t0
    int m[S], x[S], g[S], v[S], below[S];
    int x_ext[S];                               // the X tie flag, as tb bit 2
#pragma unroll
    for (int s = 0; s < S; ++s) {
      int sub = qc[s] == refc ? 0 : kMismatch;
      if (!kInside &&
          static_cast<unsigned>(jb + s - 1) >= static_cast<unsigned>(qlen))
        sub = kInf;
      m[s] = H[s] + sub;
      const int xo = (s + 1 < S ? H[s + 1] : hn) + kOE;
      const int xe = (s + 1 < S ? X[s + 1] : xn) + kGapExt;
      x[s] = min(xo, xe);
      if (EmitTb) x_ext[s] = xe <= xo ? 4 : 0;
      g[s] = min(m[s], x[s]);
      v[s] = g[s] - t0 * kGapExt - s * kGapExt;
    }
    // the thread's fold as a tree (the last slot, which waits for the
    // shuffle, joins last); the prefix inside the thread is needed only
    // after the scan
    int fold;
    {
      int f[S];
#pragma unroll
      for (int s = 0; s < S; ++s) f[s] = v[s];
#pragma unroll
      for (int w = 1; w < S; w *= 2)
#pragma unroll
        for (int s = 0; s + w < S; s += 2 * w) f[s] = min(f[s], f[s + w]);
      fold = f[0];
    }
    below[0] = INT_MAX;                         // min over this thread's s' < s
#pragma unroll
    for (int s = 1; s < S; ++s) below[s] = min(below[s - 1], v[s - 1]);

    // min of the folds of the lanes below: windows of the 4, 16 and 32
    // lanes below, three dependent shuffle rounds
    int run = min(min(max(shfl_up(fold, 1), up1), max(shfl_up(fold, 2), up2)),
                  min(max(shfl_up(fold, 3), up3), max(shfl_up(fold, 4), up4)));
    run = min(min(run, max(shfl_up(run, 4), up4)),
              min(max(shfl_up(run, 8), up8), max(shfl_up(run, 12), up12)));
    run = min(run, max(shfl_up(run, 16), up16));
    int g_before = 0;                           // g of slot t0 - 1
    if (EmitTb) g_before = shfl_up(g[S - 1], 1);
    if (kMulti) {
      if (top) {
        sh_fold[buf][warp] = min(run, fold);
        if (EmitTb) sh_g[buf][warp] = g[S - 1];
      }
      __syncthreads();
      // lane k: warp k's fold, its last slot's x put back
      int c = INT_MAX;
      if (lane < warp) {
        const int xk = sh_x[buf][lane] >> 1;
        c = min(sh_fold[buf][lane], xk - ((lane + 1) * 32 * S - 1) * kGapExt);
      }
      run = min(run, __reduce_min_sync(kFull, c));
      if (deferred) {
        const int xs = sh_x[buf][warp];
        x[S - 1] = xs >> 1;
        x_ext[S - 1] = (xs & 1) << 2;
        g[S - 1] = min(g[S - 1], x[S - 1]);
      }
      if (EmitTb && lane == 0 && warp > 0)
        g_before = min(sh_g[buf][warp - 1], sh_x[buf][warp - 1] >> 1);
    }

    const uint32_t staged = stage + buf * kStage + d + lane * S;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // 8 + 2 (t - 1) + the prefix minimum; slot 0 has none
      int y = min(wrap_add(min(run, below[s]),
                           kGapOpen + t0 * kGapExt + s * kGapExt), kInf);
      if (s == 0) y = max(y, first);
      int h = min(g[s], y);                     // y <= INF
      int xm = min(x[s], kInf);
      if (!kInside &&
          static_cast<unsigned>(jb + s) > static_cast<unsigned>(qlen))
        h = xm = kInf;
      h = max(h, pad[s]);
      xm = max(xm, pad[s]);
      if (EmitTb) {
        const int y_open =
            s ? g[s - 1] + kOE : (t0 == 0 ? kInf : g_before + kOE);
        const int g_from_x = xm < m[s];
        const int src = y < g[s] ? 2 : g_from_x;
        sts8(staged + s,
             g_from_x * 16 + (src | x_ext[s] | (y < y_open ? 8 : 0)));
      }
      low[s] = min(low[s], h);
      H[s] = h;
      X[s] = xm;
    }
    if (EmitTb) {
      __syncwarp();
      if (i > 1) stage_store(row_tb - row_step);
      row_tb += row_step;
      d_prev = d;
    }

    // the query bytes move down one slot
    int q_in = __shfl_down_sync(kFull, qc[0], 1);
    if (top) q_in = (fed >> 8) & 0xff;
#pragma unroll
    for (int s = 0; s + 1 < S; ++s) qc[s] = qc[s + 1];
    qc[S - 1] = q_in;
  };

  // rows [i_in0, i_in1]: every slot of the band inside the query (the
  // same rows for every warp of the CTA, so all take one path to the
  // barrier)
  const int i_in0 = 1 - lo, i_in1 = qlen - lo - W + 1;
  int ahead = fetch(1);
  for (int i0 = 1; i0 <= n; i0 += 32) {
    const int block = ahead;
    ahead = fetch(i0 + 32);
    const int rows = min(32, n - i0 + 1);
    int fed = __shfl_sync(kFull, block, 0);
    for (int r = 0; r < rows; ++r) {
      const int i = i0 + r;
      // the next row's bytes, asked for before this row's chain
      const int fed_next = __shfl_sync(kFull, block, (r + 1) & 31);
      if (i >= i_in0 && i <= i_in1)
        row(std::true_type{}, i, fed);
      else
        row(std::false_type{}, i, fed);
      fed = fed_next;
    }
  }

  int edge = INT_MAX;
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (t0 + s == 0 || t0 + s == W - 1) edge = min(edge, low[s]);
  if (EmitTb) {
    stage_load(stage + (n & 1) * kStage, d_prev);
    stage_store(row_tb - row_step);
  }
  edge = __reduce_min_sync(kFull, edge);
  if (kMulti) {
    if (threadIdx.x == 0) sh_edge = INT_MAX;
    __syncthreads();
    if (lane == 0) atomicMin(&sh_edge, edge);
    __syncthreads();
    edge = sh_edge;
  }
  const int te = qlen - n - lo;
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (t0 + s == te && te < W) score_out[b] = H[s];
  if (threadIdx.x == 0) {
    if (te < 0 || te >= W) score_out[b] = kInf;
    if (tend_out != nullptr) tend_out[b] = te;
    edge_out[b] = edge;
  }
}

template <int S, bool EmitTb>
int launch_reg(const void* ref, int n, const void* q, int B, int m_pad,
               const void* qlen, int lo, int W, void* tb, void* score,
               void* t_end, void* edge, int warps, cudaStream_t stream) {
  auto args = [&](auto kernel) {
    kernel<<<B, 32 * warps, 0, stream>>>(
        static_cast<const uint8_t*>(ref), n, static_cast<const uint8_t*>(q),
        m_pad, static_cast<const int*>(qlen), lo, W, B,
        static_cast<uint8_t*>(tb), static_cast<int*>(score),
        static_cast<int*>(t_end), static_cast<int*>(edge));
  };
  if (warps == 1)
    args(gotoh_reg_kernel<S, false, EmitTb>);
  else
    args(gotoh_reg_kernel<S, true, EmitTb>);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------------
// the wide kernel

constexpr int kMaxThreads = 1024;
constexpr int kSlotsPerThread = 4;
// dynamic shared memory a block may use on the H100 (227 KB), less room
// for the static per-warp totals
constexpr int kSmemBytes = 232448 - 1024;

struct Row {
  const int* hp;   // previous H row
  const int* xp;   // previous X row
  const uint8_t* q;
  int m_pad, qlen, refc, i, lo, W;
};

// m, x and the X tie flag of slot t; g = min(m, x)
__device__ __forceinline__ void cell(const Row& r, int t, int& m, int& x,
                                     bool& x_from_ext) {
  const int j = r.i + r.lo + t;
  int sub = kInf;
  if (j >= 1 && j <= r.qlen) {
    const int c = (j - 1 < r.m_pad) ? r.q[j - 1] : 0;
    sub = c == r.refc ? 0 : kMismatch;
  }
  m = r.hp[t] + sub;
  const int xo = (t + 1 < r.W ? r.hp[t + 1] : kInf) + kOE;
  const int xe = (t + 1 < r.W ? r.xp[t + 1] : kInf) + kGapExt;
  x = min(xo, xe);
  x_from_ext = xe <= xo;
}

template <bool EmitTb>
__global__ void __launch_bounds__(kMaxThreads)
gotoh_wide_kernel(const uint8_t* __restrict__ ref, int n,
                  const uint8_t* __restrict__ q, int m_pad,
                  const int* __restrict__ qlens, int lo, int W, int per,
                  int q_in_smem, int* __restrict__ scratch, int B,
                  uint8_t* __restrict__ tb, int* __restrict__ score_out,
                  int* __restrict__ tend_out, int* __restrict__ edge_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_min[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b = blockIdx.x;
  const int qlen = qlens[b];

  unsigned char* free_smem = smem;
  int* hx;                 // [H0 | H1 | X0 | X1], W ints each
  if (scratch == nullptr) {
    hx = reinterpret_cast<int*>(free_smem);
    free_smem += 16 * static_cast<size_t>(W);
  } else {
    hx = scratch + static_cast<size_t>(b) * 4 * W;
  }
  const uint8_t* qrow = q + static_cast<size_t>(b) * m_pad;
  if (q_in_smem) {
    for (int k = tid; k < m_pad; k += blockDim.x) free_smem[k] = qrow[k];
    qrow = free_smem;
  }

  const int t0 = min(tid * per, W), t1 = min(t0 + per, W);
  for (int t = t0; t < t1; ++t) {          // row 0
    const int j0 = t + lo;
    int h = j0 == 0 ? 0 : (j0 > 0 ? kGapOpen + kGapExt * j0 : kInf);
    hx[t] = j0 > qlen ? kInf : h;
    hx[2 * W + t] = kInf;
  }
  __syncthreads();
  int edge = 0;
  if (tid == 0) edge = min(hx[0], hx[W - 1]);

  int cur = 0;
  int refn = ref[0];
  for (int i = 1; i <= n; ++i) {
    Row r{hx + cur * W, hx + 2 * W + cur * W, qrow, m_pad, qlen, refn, i,
          lo, W};
    if (i < n) refn = ref[i];
    int* hn = hx + (cur ^ 1) * W;
    int* xn = hx + 2 * W + (cur ^ 1) * W;

    // pass 1: this thread's min over its slots of g[t] - 2t
    int agg = INT_MAX;
    for (int t = t0; t < t1; ++t) {
      int m, x;
      bool fe;
      cell(r, t, m, x, fe);
      agg = min(agg, min(m, x) - t * kGapExt);
    }
    // block exclusive prefix min of the per-thread values
    int incl = agg;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = min(incl, v);
    }
    int excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = INT_MAX;
    if (lane == 31) warp_min[wid] = incl;
    __syncthreads();
    if (wid == 0) {
      int v = lane < nwarps ? warp_min[lane] : INT_MAX;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v = min(v, u);
      }
      warp_min[lane] = v;
    }
    __syncthreads();
    int run = min(excl, wid > 0 ? warp_min[wid - 1] : INT_MAX);

    // pass 2: the cells again, with the prefix min run on
    int gprev = 0;
    if (t0 > 0 && t0 < t1) {
      int m, x;
      bool fe;
      cell(r, t0 - 1, m, x, fe);
      gprev = min(m, x);
    }
    uint8_t* tbrow =
        EmitTb ? tb + (static_cast<size_t>(i - 1) * B + b) * W : nullptr;
    for (int t = t0; t < t1; ++t) {
      int m, x;
      bool x_from_ext;
      cell(r, t, m, x, x_from_ext);
      const int g = min(m, x);
      const int j = i + lo + t;
      const bool jv = j >= 0 && j <= qlen;
      const int y = t == 0 ? kInf : min(kOE + (t - 1) * kGapExt + run, kInf);
      const int h = jv ? min(min(g, y), kInf) : kInf;
      const int xm = jv ? min(x, kInf) : kInf;
      hn[t] = h;
      xn[t] = xm;
      if (EmitTb) {
        const int y_open = t == 0 ? kInf : gprev + kOE;
        const int g_from_x = xm < m;
        const int src = y < g ? 2 : g_from_x;
        tbrow[t] = static_cast<uint8_t>(src | (int(x_from_ext) << 2) |
                                        (int(y < y_open) << 3) |
                                        (g_from_x << 4));
      }
      gprev = g;
      run = min(run, g - t * kGapExt);
    }
    __syncthreads();
    if (tid == 0) edge = min(edge, min(hn[0], hn[W - 1]));
    cur ^= 1;
  }

  if (tid == 0) {
    const int* hf = hx + cur * W;
    const int te = qlen - n - lo;
    score_out[b] = (te >= 0 && te < W) ? hf[te] : kInf;
    if (tend_out != nullptr) tend_out[b] = te;
    edge_out[b] = edge;
  }
}

template <bool EmitTb>
int launch_wide(const void* ref, int n, const void* q, int B, int m_pad,
                const void* qlen, int lo, int W, void* tb, void* score,
                void* t_end, void* edge, void* scratch, cudaStream_t stream) {
  const long hx_bytes = scratch == nullptr ? 16L * W : 0;
  if (hx_bytes > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const long q_bytes = (static_cast<long>(m_pad) + 15) / 16 * 16;
  const int q_in_smem = hx_bytes + q_bytes <= kSmemBytes;
  const size_t smem = static_cast<size_t>(hx_bytes + (q_in_smem ? q_bytes : 0));
  int threads = (W + kSlotsPerThread - 1) / kSlotsPerThread;
  threads = min(kMaxThreads, (threads + 31) / 32 * 32);
  const int per = (W + threads - 1) / threads;
  auto kernel = gotoh_wide_kernel<EmitTb>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<B, threads, smem, stream>>>(
      static_cast<const uint8_t*>(ref), n, static_cast<const uint8_t*>(q),
      m_pad, static_cast<const int*>(qlen), lo, W, per, q_in_smem,
      static_cast<int*>(scratch), B, static_cast<uint8_t*>(tb),
      static_cast<int*>(score), static_cast<int*>(t_end),
      static_cast<int*>(edge));
  return static_cast<int>(cudaGetLastError());
}

// slots == 0: the wide kernel.  Otherwise the register kernel with
// `slots` band slots a thread and `warps` warps a query row, which must
// cover the band: one of the instantiated slot counts, 1..8 warps,
// 32 * warps * slots >= W.
template <bool EmitTb>
int launch(const void* ref, int n, const void* q, int B, int m_pad,
           const void* qlen, int lo, int W, void* tb, void* score,
           void* t_end, void* edge, void* scratch, int slots, int warps,
           cudaStream_t stream) {
  if (n < 1 || W < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (slots == 0)
    return launch_wide<EmitTb>(ref, n, q, B, m_pad, qlen, lo, W, tb, score,
                               t_end, edge, scratch, stream);
  if (warps < 1 || warps > kRegMaxWarps || 32L * warps * slots < W)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (slots) {
#define UVT_GOTOH_SLOTS(S)                                                  \
  case S:                                                                   \
    return launch_reg<S, EmitTb>(ref, n, q, B, m_pad, qlen, lo, W, tb,      \
                                 score, t_end, edge, warps, stream);
    UVT_GOTOH_SLOTS(1)
    UVT_GOTOH_SLOTS(2)
    UVT_GOTOH_SLOTS(3)
    UVT_GOTOH_SLOTS(4)
    UVT_GOTOH_SLOTS(5)
    UVT_GOTOH_SLOTS(6)
    UVT_GOTOH_SLOTS(9)
    UVT_GOTOH_SLOTS(17)
#undef UVT_GOTOH_SLOTS
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// ref: (n,) uint8; q: (B, m_pad) uint8; qlen: (B,) int32; tb: (n, B, W)
// uint8; score, t_end, edge: (B,) int32.  slots, warps: the variant, as
// ops/gotoh_kernels.py:forward_plan chooses it from W (slots == 0: the
// wide kernel, whose scratch is (B, 4, W) int32 when 16*W bytes exceed
// the shared-memory budget, else null).  Launches on `stream`; returns
// cudaGetLastError() (or the attribute / argument error).
extern "C" int uvt_gotoh_forward(const void* ref, int n, const void* q,
                                 int B, int m_pad, const void* qlen, int lo,
                                 int W, void* tb, void* score, void* t_end,
                                 void* edge, void* scratch, int slots,
                                 int warps, void* stream) {
  return launch<true>(ref, n, q, B, m_pad, qlen, lo, W, tb, score, t_end,
                      edge, scratch, slots, warps,
                      static_cast<cudaStream_t>(stream));
}

// The same forward without the traceback buffer: score and edge only.
extern "C" int uvt_gotoh_score(const void* ref, int n, const void* q, int B,
                               int m_pad, const void* qlen, int lo, int W,
                               void* score, void* edge, void* scratch,
                               int slots, int warps, void* stream) {
  return launch<false>(ref, n, q, B, m_pad, qlen, lo, W, nullptr, score,
                       nullptr, edge, scratch, slots, warps,
                       static_cast<cudaStream_t>(stream));
}
