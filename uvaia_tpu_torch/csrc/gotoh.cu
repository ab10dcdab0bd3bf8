// Banded affine Gotoh forward: the hand-written Hopper kernel that
// replaces uvaia_tpu/ops/pallas_gotoh.py:_fwd_kernel (traceback bytes,
// EmitTb = true) and pallas_gotoh.py:_score_kernel (score only).
//
// What it computes is uvaia_tpu/ops/gotoh.py:_row_kernel, cell for cell:
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
// _row_kernel makes the kernel equal its plain version at every cell.
//
// Design.  One CTA per query row b; thread k owns the contiguous slots
// [k*per, (k+1)*per).  The previous H and X rows are double buffered, so
// a row's reads never race its writes: in shared memory while 16*W bytes
// fit (W <= 14,464), else in a (B, 4, W) device-memory scratch buffer the
// wrapper allocates (the same code through a generic pointer).  The query
// row is staged once in shared memory when it fits beside them, and read
// from device memory otherwise.  A row is two passes over the owned
// slots: pass 1 folds min(g - 2t) per thread; a block exclusive prefix
// min (warp shuffles, then the per-warp totals in shared memory) gives
// each thread min_{s<t0}; pass 2 recomputes the cells, runs the prefix
// on, and writes H, X and the tb byte.  The Pallas kernel's super-window
// read, lane roll and 128-row grid chunks existed only for Mosaic.
//
// What bounds it on the H100: a serial chain of n rows, each with three
// block barriers and a log2-depth scan, so latency and not bytes.  The
// tb write is B*n*W bytes (3.9 GB for a pool of 1,024 at n = 29,903,
// W = 129: 1.2 ms at 3.35 TB/s).  Parallelism comes from the B CTAs.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 28;
constexpr int kMismatch = 4;
constexpr int kGapOpen = 6;
constexpr int kGapExt = 2;
constexpr int kOE = kGapOpen + kGapExt;
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
gotoh_kernel(const uint8_t* __restrict__ ref, int n,
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
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl = min(incl, v);
    }
    int excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = INT_MAX;
    if (lane == 31) warp_min[wid] = incl;
    __syncthreads();
    if (wid == 0) {
      int v = lane < nwarps ? warp_min[lane] : INT_MAX;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
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
int launch(const void* ref, int n, const void* q, int B, int m_pad,
           const void* qlen, int lo, int W, void* tb, void* score,
           void* t_end, void* edge, void* scratch, cudaStream_t stream) {
  const long hx_bytes = scratch == nullptr ? 16L * W : 0;
  if (n < 1 || W < 1 || B < 1 || hx_bytes > kSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const long q_bytes = (static_cast<long>(m_pad) + 15) / 16 * 16;
  const int q_in_smem = hx_bytes + q_bytes <= kSmemBytes;
  const size_t smem = static_cast<size_t>(hx_bytes + (q_in_smem ? q_bytes : 0));
  int threads = (W + kSlotsPerThread - 1) / kSlotsPerThread;
  threads = min(kMaxThreads, (threads + 31) / 32 * 32);
  const int per = (W + threads - 1) / threads;
  auto kernel = gotoh_kernel<EmitTb>;
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

}  // namespace

// ref: (n,) uint8; q: (B, m_pad) uint8; qlen: (B,) int32; tb: (n, B, W)
// uint8; score, t_end, edge: (B,) int32; scratch: (B, 4, W) int32 when
// 16*W bytes exceed the shared-memory budget, else null.  Launches on
// `stream`; returns cudaGetLastError() (or the attribute / argument
// error).
extern "C" int uvt_gotoh_forward(const void* ref, int n, const void* q,
                                 int B, int m_pad, const void* qlen, int lo,
                                 int W, void* tb, void* score, void* t_end,
                                 void* edge, void* scratch, void* stream) {
  return launch<true>(ref, n, q, B, m_pad, qlen, lo, W, tb, score, t_end,
                      edge, scratch, static_cast<cudaStream_t>(stream));
}

// The same forward without the traceback buffer: score and edge only.
extern "C" int uvt_gotoh_score(const void* ref, int n, const void* q, int B,
                               int m_pad, const void* qlen, int lo, int W,
                               void* score, void* edge, void* scratch,
                               void* stream) {
  return launch<false>(ref, n, q, B, m_pad, qlen, lo, W, nullptr, score,
                       nullptr, edge, scratch,
                       static_cast<cudaStream_t>(stream));
}
