// The events traceback walk: the hand-written Hopper kernel that replaces
// the torch-op loop of ops/gotoh.py:walk_events_plain on the card.  It
// replaces no Pallas kernel: the JAX package walks the traceback with a
// lax.while_loop of XLA ops (uvaia_tpu/ops/gotoh.py:gotoh_traceback_events).
//
// What it computes is walk_events_plain, iteration for iteration, so every
// output (ev_i, ev_t, cnt, done, edge, ovf) is equal on any traceback
// bytes, corrupt ones included.  A walker sits on state (i, t) with
// j = i + t + lo and reads tb byte tb[clamp(i-1), b, clamp(t)] (rows and
// slots clamp into the buffer).  An iteration of an active row (i > 0 or
// j > 0):
//   * classifies the state: a leading insertion (i == 0) or a leading
//     deletion (j == 0), each retired whole in closed form, else an M, X
//     or Y move by the carried kind `mat`;
//   * records the checkpoint (i, t) where the kind differs from the last
//     iteration's (the first iteration records none), or counts an
//     overflow once K are recorded;
//   * probes PROBE = 128 cells along the run's direction and takes the
//     run's length: the cells up to the first that breaks it (M: a byte
//     whose source is not M; X / Y: a byte before it without the
//     extension bit), capped by the rows or columns left;
//   * an M run also jumps to the start of the 256-row block or of the
//     4096-row block of its top row where every byte of that block at the
//     run's slot is M-sourced (the all-M flags, built by allm_flags_kernel
//     over the whole buffer);
//   * lands, and takes the next kind from the run's last byte and the
//     byte it lands on.
// An inactive row changes nothing, so a row's walk is its own: the
// plain version's loop over the batch, which runs until no row is active
// or max_iters iterations, gives each row what this kernel's loop of at
// most max_iters iterations on that row alone gives.  A row whose
// iteration leaves its state unchanged (a corrupt byte with source 3, a
// column left of the band) would repeat it to the cap; the kernel stops
// it there, with the same outputs.
//
// What bounds it on the H100: latency.  An iteration is a chain: the
// probe's bytes depend on the state, the run length on the bytes, the
// next state on the run length, so a row costs its iterations times one
// device-memory round trip plus its arithmetic, whatever the card's
// bandwidth.  The torch version paid ~100 launches an iteration and a
// host read every 8.  Here one warp walks one row, lane k holding probe
// cells k, k + 32, k + 64 and k + 96: the 128 loads leave together, four
// ballots give the run as 128 bits, and the run length is a count of
// trailing ones.  The byte a run lands on is the probe cell just past it
// (one shuffle) unless the run used all 128 cells or an M block jump, and
// an X or Y run that goes on past the probe needs no landing byte.  Lane
// 0 loads the two block flags beside the probe and shuffles them out;
// every lane keeps the row's scalar state, so no other exchange is
// needed.  Rows run side by side, one warp a CTA, B CTAs; no host read.
//
// The flags kernel reads the buffer once, a thread a 256-row block of a
// (b, slot) column with sixteen loads in flight, and leaves the block at
// the first byte that is not M-sourced: only the slots an M run follows
// are read whole, and a block's read is a chain of 16 loads, not the
// 256 of a 4096-row block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kProbe = 128;       // ops/gotoh.py PROBE
constexpr int kBlock1 = 256;      // ops/gotoh.py _all_m_blocks
constexpr int kBlocksPer2 = 16;   // 256-row blocks in a 4096-row block
constexpr int kFlagThreads = 256;
constexpr int kFlagUnroll = 16;
constexpr unsigned kFull = 0xffffffffu;

// allm2 must hold 1 in every byte on entry: a 256-row block that is not
// all M clears its 4096-row block's flag (stores of one value, in any
// order)
__global__ void __launch_bounds__(kFlagThreads)
allm_flags_kernel(const uint8_t* __restrict__ tb, int n, long bw, int n1,
                  uint8_t* __restrict__ allm1, uint8_t* __restrict__ allm2) {
  const long pos = blockIdx.x * static_cast<long>(kFlagThreads) + threadIdx.x;
  if (pos >= bw) return;
  for (int k = blockIdx.y; k < n1; k += gridDim.y) {
    const int r_end = min(kBlock1 * (k + 1), n);
    int all1 = 1;
    for (int r = kBlock1 * k; r < r_end && all1; r += kFlagUnroll) {
      int v[kFlagUnroll];
#pragma unroll
      for (int u = 0; u < kFlagUnroll; ++u)
        v[u] = r + u < r_end ? tb[(r + u) * bw + pos] : 0;
#pragma unroll
      for (int u = 0; u < kFlagUnroll; ++u) all1 &= (v[u] & 3) == 0;
    }
    allm1[k * bw + pos] = static_cast<uint8_t>(all1);
    if (!all1) allm2[(k / kBlocksPer2) * bw + pos] = 0;
  }
}

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// cells of a 128-bit mask set from bit 0 up to the first clear one
__device__ __forceinline__ int trailing_ones(unsigned long long lo,
                                             unsigned long long hi) {
  if (~lo != 0ull) return __ffsll(static_cast<long long>(~lo)) - 1;
  if (~hi != 0ull) return 64 + __ffsll(static_cast<long long>(~hi)) - 1;
  return 128;
}

__global__ void __launch_bounds__(32)
walk_events_kernel(const uint8_t* __restrict__ tb, int n, int B, int W,
                   const int* __restrict__ t_end, int lo, int K,
                   const uint8_t* __restrict__ allm1,
                   const uint8_t* __restrict__ allm2, int n1, int n2,
                   long long max_iters, int* __restrict__ ev_i,
                   int* __restrict__ ev_t, int* __restrict__ cnt_out,
                   bool* __restrict__ done_out, bool* __restrict__ edge_out,
                   bool* __restrict__ ovf_out) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const long long bw = static_cast<long long>(B) * W;
  const uint8_t* row = tb + static_cast<long long>(b) * W;   // (r, s): r*bw+s
  const uint8_t* f1 = allm1 + static_cast<long long>(b) * W;
  const uint8_t* f2 = allm2 + static_cast<long long>(b) * W;
  int* evi = ev_i + static_cast<long long>(b) * K;
  int* evt = ev_t + static_cast<long long>(b) * K;
  // the byte of state (i, t), clamped as every read of the walk is
  auto read = [&](long long i, long long t) -> int {
    return row[clampll(i - 1, 0, n - 1) * bw + clampll(t, 0, W - 1)];
  };

  long long i = n, t = t_end[b];
  int mat = read(i, t) & 3;
  int kprev = -1;
  long long cnt = 0;
  bool edge = false, ovf = false;
  for (long long it = 0; it < max_iters; ++it) {
    const long long j = i + t + lo;
    if (!(i > 0 || j > 0)) break;                      // inactive: done
    const bool lead_y = i == 0;
    const bool col0_x = i > 0 && j == 0;
    const bool inner = i > 0 && j > 0;
    const bool is_m = inner && mat == 0;
    const bool is_x = inner && mat == 1;
    const bool is_y = inner && mat == 2;
    const int kind = is_m ? 0 : (is_x || col0_x) ? 1 : 2;
    if (kprev >= 0 && kind != kprev) {
      if (cnt < K) {
        if (lane == 0) {
          evi[cnt] = static_cast<int>(i);
          evt[cnt] = static_cast<int>(t);
        }
      } else {
        ovf = true;
      }
      ++cnt;
    }
    kprev = kind;

    long long r = 0, ni = i;                 // cells retired; next row
    int di = 0, dt = 0, nmat = mat;
    if (is_m || is_x || is_y) {
      di = is_y ? 0 : 1;
      dt = is_x ? 1 : (is_y ? -1 : 0);
      const long long tcl = clampll(t, 0, W - 1);
      const long long blk1 = min((i - 1) / kBlock1, static_cast<long long>(n1 - 1));
      const long long blk2 =
          min((i - 1) / (kBlock1 * kBlocksPer2), static_cast<long long>(n2 - 1));
      int flags = 0;
      if (is_m && lane == 0)
        flags = f1[blk1 * bw + tcl] | (f2[blk2 * bw + tcl] << 1);
      int v[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const long long k = lane + 32 * s;
        v[s] = row[clampll(i - 1 - k * di, 0, n - 1) * bw +
                   clampll(t + k * dt, 0, W - 1)];
      }
      flags = __shfl_sync(kFull, flags, 0);
      // M: a cell continues the run where its own byte is M-sourced; X, Y:
      // where the byte before it carries the extension bit
      const int shift = is_x ? 2 : 3;
      unsigned bits[4];
#pragma unroll
      for (int s = 0; s < 4; ++s)
        bits[s] = __ballot_sync(
            kFull, is_m ? (v[s] & 3) == 0 : (v[s] >> shift) & 1);
      const unsigned long long plo = bits[0] | (static_cast<unsigned long long>(bits[1]) << 32);
      const unsigned long long phi = bits[2] | (static_cast<unsigned long long>(bits[3]) << 32);
      const int ones = trailing_ones(plo, phi);
      const long long lim = is_m ? min(i, j) : (is_x ? i : j);
      const int runlen = static_cast<int>(
          min(static_cast<long long>(is_m ? ones : min(ones + 1, kProbe)), lim));
      r = runlen;
      if (is_m) {
        long long i2 = i - runlen;
        if (flags & 1) i2 = min(i2, blk1 * kBlock1);
        if (flags & 2) i2 = min(i2, blk2 * kBlock1 * kBlocksPer2);
        ni = max(i2, max(-t - lo, 0ll));
      } else {
        ni = i - r * di;
      }
      // the extension bit of the run's last byte (X, Y: runlen >= 1)
      const int e = runlen - 1;
      const bool ext =
          !is_m && ((e < 64 ? plo >> e : phi >> (e - 64)) & 1ull) != 0;
      if (ext) {
        nmat = is_x ? 1 : 2;
      } else {
        // the landing byte: the probe cell past the run where the run
        // ended inside the probe, else a read
        int nxt;
        if (runlen < kProbe && ni == i - runlen * di) {
          const int sel = runlen >> 5;
          const int mine = sel == 0 ? v[0] : sel == 1 ? v[1]
                         : sel == 2 ? v[2] : v[3];
          nxt = __shfl_sync(kFull, mine, runlen & 31);
        } else {
          nxt = read(ni, t + r * dt);
        }
        nmat = is_m ? (nxt & 3) : (is_x ? (nxt & 3) : ((nxt >> 4) & 1));
      }
    } else if (lead_y) {
      r = j;
      dt = -1;
    } else if (col0_x) {
      r = i;
      di = 1;
      dt = 1;
      ni = 0;
    }
    const long long span = dt * max(r - 1, 0ll);
    edge = edge || (i > 0 && (t + min(span, 0ll) <= 0 ||
                              t + max(span, 0ll) >= W - 1));
    const long long nt = t + r * dt;
    if (ni == i && nt == t && nmat == mat) break;  // every later one idle
    i = ni;
    t = nt;
    mat = nmat;
  }

  const long long kept = min(cnt, static_cast<long long>(K));
  for (long long s = kept + lane; s < K; s += 32) {
    evi[s] = 0;
    evt[s] = 0;
  }
  if (lane == 0) {
    cnt_out[b] = static_cast<int>(cnt);
    done_out[b] = i == 0 && i + t + lo == 0;
    edge_out[b] = edge;
    ovf_out[b] = ovf;
  }
}

}  // namespace

// tb: (n, B, W) uint8; allm1: (n1, B, W) uint8, n1 = ceil(n / 256);
// allm2: (n2, B, W) uint8, n2 = ceil(n1 / 16).  Every 256-row block's and
// every 4096-row block's "all M-sourced" flag of each (b, slot), a partial
// last block over the rows it has.  Launches on `stream`; returns
// cudaGetLastError() (or the argument error).
extern "C" int uvt_allm_flags(const void* tb, int n, int B, int W,
                              void* allm1, void* allm2, void* stream) {
  if (n < 1 || B < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long bw = static_cast<long>(B) * W;
  const int n1 = (n + kBlock1 - 1) / kBlock1;
  const int n2 = (n1 + kBlocksPer2 - 1) / kBlocksPer2;
  const long cols = (bw + kFlagThreads - 1) / kFlagThreads;
  if (cols > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(allm2, 1, n2 * bw, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(cols), min(n1, 65535));
  allm_flags_kernel<<<grid, kFlagThreads, 0, s>>>(
      static_cast<const uint8_t*>(tb), n, bw, n1,
      static_cast<uint8_t*>(allm1), static_cast<uint8_t*>(allm2));
  return static_cast<int>(cudaGetLastError());
}

// The events walk of every row of tb from (n, t_end[b]): ev_i, ev_t
// (B, K) int32, cnt (B,) int32, done, edge, ovf (B,) bool; allm1 and allm2
// as uvt_allm_flags leaves them; at most max_iters iterations a row.
// Launches on `stream`; returns cudaGetLastError() (or the argument
// error).
extern "C" int uvt_walk_events(const void* tb, int n, int B, int W,
                               const void* t_end, int lo, int K,
                               const void* allm1, const void* allm2,
                               long max_iters, void* ev_i, void* ev_t,
                               void* cnt, void* done, void* edge, void* ovf,
                               void* stream) {
  if (n < 1 || B < 1 || W < 1 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n1 = (n + kBlock1 - 1) / kBlock1;
  const int n2 = (n1 + kBlocksPer2 - 1) / kBlocksPer2;
  walk_events_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tb), n, B, W,
      static_cast<const int*>(t_end), lo, K,
      static_cast<const uint8_t*>(allm1), static_cast<const uint8_t*>(allm2),
      n1, n2, max_iters, static_cast<int*>(ev_i), static_cast<int*>(ev_t),
      static_cast<int*>(cnt), static_cast<bool*>(done),
      static_cast<bool*>(edge), static_cast<bool*>(ovf));
  return static_cast<int>(cudaGetLastError());
}
