// Selective-scan (Mamba S6) backward for Hopper (sm_90a): a segment-parallel
// reverse scan.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of the JAX package's
// kernels/selective_scan.py:227-302 (launched by `_bwd_call`, :415-498,
// pl.pallas_call at :457).  From the forward's inputs, the chunk-start
// states that the training variant of selective_scan_fwd.cu saved, the
// cotangent dy of the (pre-gate) output and dlast of the last state, it
// computes, for every (b, d, n) and t, with a_t = exp(dt_t * A):
//
//   g_t     = C_t * dy_t + a_{t+1} * g_{t+1}        g_{L-1} seeded with dlast
//   du_t    = dt_t * sum_n g_t B_t + D * dy_t
//   ddelta  = (u_t * sum_n g_t B_t + sum_n g_t h_{t-1} a_t A)
//             * sigmoid(delta_t + bias)              (when `softplus` is set)
//   dB_t[n] = sum_d g_t dt_t u_t      dC_t[n] = sum_d h_t dy_t
//   dA      = sum_t g_t h_{t-1} a_t dt_t            dD = sum_t dy_t u_t
//   dbias   = sum_t ddelta_t                        dh0 = a_0 g_0
//
// Sequence grads (ddelta, du, dB, dC) are written in the input dtype,
// parameter grads (dA, dD, dbias, dh0) per batch row in fp32; the caller sums
// them over the batch where a parameter was shared.  State and sums are fp32.
//
// Design.  One thread owns one (b, d, n) state and a channel's N = 16 states
// are a half warp that reduces over n with __shfl_xor_sync.  A block holds
// kCh = 16 channels (256 threads).  The main kernel walks chunks of kChunk
// steps from right to left.  For each chunk it stages the chunk's u, dt,
// sigmoid, dy (per channel) and B, C (per n) in shared memory with coalesced
// loads, recomputes h forward from the saved chunk-start state into kChunk
// registers (the recurrence is never inverted: a underflows), then walks the
// chunk backward carrying ga = a_{t+1} g_{t+1} in a register.
//
// The carry is linear: the ga that leaves a stretch of steps at its left edge
// is the ga that stretch produces from zero plus exp(A * sum dt) times the ga
// that entered it at the right.  So L is cut into segments of `l_seg` steps
// (a multiple of kChunk chosen by the wrapper per shape, so that the grid
// fills the SMs once; every segment starts on a saved chunk state, the last
// one is shorter), and the grid is (ceil(D / kCh), segments, batch).  Four
// passes, GA_k being the carry that enters segment k from the right:
//   A (local kernel): every segment but the first walks its steps right to
//     left from ga = 0, reading only delta, C and dy (one exp and two FMAs
//     per state and step), and writes gloc_k, the ga leaving its left edge,
//     and S_k = sum of its dt to the scratch `gbuf` / `sbuf`;
//   B (carry kernel): one thread per (b, d, n) walks the segments right to
//     left, GA_{last} = dlast or 0, GA_{k-1} = gloc_k + exp(A * S_k) * GA_k,
//     and writes GA_{k-1} over gloc_k (the product may underflow to 0: the
//     carry has vanished; nothing divides by it);
//   C (main kernel): every segment walks its chunks from GA_k and writes du,
//     ddelta, its dB / dC partials and per-segment partials of dA, dD and
//     dbias; the first segment writes dh0;
//   D (summing kernels): the dB / dC partials summed over the channel
//     blocks, the parameter partials over the segments, each in a fixed
//     order.
// With one segment, passes A and B are skipped and pass C writes the
// parameter grads itself.  dB and dC sum over all of d, across blocks (the
// sum the Pallas version loses when d > 128, ROADMAP F1): a block reduces its
// channels (one shuffle across the two channels of a warp, then shared memory
// across its warps) and writes one fp32 partial per (block, b, t, n);
// segments split t, so each partial is written once.  Nothing uses atomics,
// so the result is deterministic.  Ragged L and d are masked; nothing is
// padded.  The wrapper allocates one fp32 scratch buffer, which
// vivim_selective_scan_bwd_scratch() sizes and `layout` cuts.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  The function must read u, delta,
// dy (3 * L * D), B and C (2 * L * N) and the chunk states, and write ddelta
// and du (2 * L * D) and dB and dC (2 * L * N).  At Vivim-b3's training stage
// 0 (batch 9 = 3 directions x 3 clips, L = 20480, D = 128, fp32) that is
// about 0.61 GB, about 0.18 ms (0.09 GB of it the chunk states, one per
// kChunk = 16 steps).  Its arithmetic (the recompute and the adjoint, about
// 21 operations per state and step, an exp counted as one, plus about 20 per
// channel and step) is about 8.4 GFLOP, 0.13 ms at the 67 TFLOP/s of fp32
// outside the tensor cores: the two bounds are close.
//
// Expected weakness: each block still walks its segment in sequence, one
// chunk at a time, with three __syncthreads and two half-warp shuffle
// reductions per step, so the kernel is latency-bound; the segments only put
// more blocks in flight.  Pass A reads delta, C and dy a second time, and the
// partials add 2 * N * 4 bytes per (block, b, t) of traffic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;                  // d_state: lanes per channel
// channels per block; the wrapper reads it through
// vivim_selective_scan_bwd_channels() to size the grid and pick l_seg
constexpr int kCh = 16;
constexpr int kThreads = kN * kCh;      // 256
constexpr int kWarps = kThreads / 32;
// blocks per SM the wrapper's l_seg aims at: caps registers at 64
constexpr int kMinBlocks = 4;
constexpr int kChunk = 16;              // = selective_scan_fwd.cu's kChunk
constexpr int kCarryThreads = 64;
static_assert(kChunk * kCh == kThreads, "one staged (t, channel) per thread");
static_assert(kChunk * kN == kThreads, "one staged (t, n) per thread");

struct Params {
  const void* u;
  const void* delta;
  const void* B;
  const void* C;
  const void* dy;
  const float* A;       // (pb, D, N), batch stride A_sb (0 = shared)
  const float* Dskip;   // (pb, D), batch stride D_sb
  const float* bias;    // (pb, D), batch stride bias_sb
  const float* cs;      // (batch, n_chunks, D, N) chunk-start states
  const float* dlast;   // (batch, D, N) or null (= 0)
  void* ddelta;         // (batch, L, D) contiguous, in T
  void* du;             // (batch, L, D) contiguous, in T
  float* dA;            // (batch, D, N)
  float* dD;            // (batch, D)
  float* dbias;         // (batch, D)
  float* dh0;           // (batch, D, N)
  float* part;          // (n_blocks, 2, batch, L, N): dB, dC partials
  float* gbuf;          // (batch, n_seg - 1, D, N): gloc_k, then GA_{k-1}
  float* sbuf;          // (batch, n_seg - 1, D): S_k
  // (n_seg, batch, D[, N]) parameter-grad partials; dA, dD, dbias when
  // there is one segment
  float* pdA;
  float* pdD;
  float* pdbias;
  int batch, L, D, l_seg, n_seg;
  int64_t u_sb, u_sl, dl_sb, dl_sl, B_sb, B_sl, C_sb, C_sl, dy_sb, dy_sl;
  int64_t A_sb, D_sb, bias_sb;
  int softplus;
};

// Offsets (fp32 elements) of the pieces of the scratch buffer.
struct Layout {
  int64_t part, gbuf, sbuf, pdA, pdD, pdbias, total;
};

Layout layout(int batch, int L, int D, int n_seg) {
  const int64_t bd = (int64_t)batch * D;
  const int64_t carries = n_seg > 1 ? n_seg - 1 : 0;
  const int64_t partials = n_seg > 1 ? n_seg : 0;
  Layout s;
  s.part = 0;
  s.gbuf = s.part + (int64_t)((D + kCh - 1) / kCh) * 2 * batch * L * kN;
  s.sbuf = s.gbuf + carries * bd * kN;
  s.pdA = s.sbuf + carries * bd;
  s.pdD = s.pdA + partials * bd * kN;
  s.pdbias = s.pdD + partials * bd;
  s.total = s.pdbias + partials * bd;
  return s;
}

int64_t segments(int L, int l_seg) {
  return L == 0 ? 1 : ((int64_t)L + l_seg - 1) / l_seg;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// dt from delta + bias: passes A and C share this expression, so S_k sums
// the very dt that pass C walks
__device__ __forceinline__ float step_dt(float raw, int softplus) {
  return softplus ? (raw > 20.f ? raw : log1pf(expf(raw))) : raw;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = kN / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Pass A: segment blockIdx.y + 1 walked from a zero carry.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
selective_scan_bwd_local_kernel(Params p) {
  __shared__ float s_dt[kChunk][kCh], s_dy[kChunk][kCh], s_C[kChunk][kN];

  const int tid = threadIdx.x;
  const int n = tid % kN;
  const int c = tid / kN;
  const int blk = blockIdx.x;
  const int seg = blockIdx.y + 1;
  const int64_t b = blockIdx.z;
  const int d = blk * kCh + c;
  const bool live = d < p.D;
  const float a_n =
      live ? p.A[b * p.A_sb + (int64_t)d * kN + n] : 0.f;

  const int st_i = tid / kCh, st_c = tid % kCh, st_d = blk * kCh + st_c;
  const bool st_live = st_d < p.D;
  const float st_bias = st_live ? p.bias[b * p.bias_sb + st_d] : 0.f;
  const int sn_i = tid / kN, sn_n = tid % kN;
  const T* dl_p = static_cast<const T*>(p.delta) + b * p.dl_sb + st_d;
  const T* dy_p = static_cast<const T*>(p.dy) + b * p.dy_sb + st_d;
  const T* C_p = static_cast<const T*>(p.C) + b * p.C_sb + sn_n;

  const int64_t seg_chunks = p.l_seg / kChunk;
  const int64_t k_lo = seg * seg_chunks;
  const int64_t n_chunks = (p.L + kChunk - 1) / kChunk;
  const int64_t k_hi =
      k_lo + seg_chunks < n_chunks ? k_lo + seg_chunks : n_chunks;
  float ga = 0.f, S = 0.f;
  for (int64_t k = k_hi - 1; k >= k_lo; --k) {
    const int t0 = (int)k * kChunk;
    __syncthreads();
    {
      const int t = t0 + st_i;
      const bool ok = st_live && t < p.L;
      const float raw = ok ? to_f(dl_p[t * p.dl_sl]) + st_bias : 0.f;
      s_dt[st_i][st_c] = ok ? step_dt(raw, p.softplus) : 0.f;
      s_dy[st_i][st_c] = ok ? to_f(dy_p[t * p.dy_sl]) : 0.f;
      const int tn = t0 + sn_i;
      s_C[sn_i][sn_n] = tn < p.L ? to_f(C_p[tn * p.C_sl]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = kChunk - 1; i >= 0; --i) {
      if (t0 + i >= p.L) continue;  // uniform over the block
      const float dt = s_dt[i][c];
      const float g = ga + s_C[i][n] * s_dy[i][c];
      ga = expf(dt * a_n) * g;
      S += dt;
    }
  }
  if (live) {
    const int64_t slot = (b * (p.n_seg - 1) + seg - 1) * p.D + d;
    p.gbuf[slot * kN + n] = ga;
    if (n == 0) p.sbuf[slot] = S;
  }
}

// Pass B: one thread per (b, d, n) carries ga over the segments, right to
// left.  Slot k - 1 of gbuf / sbuf holds segment k's gloc_k / S_k and takes
// GA_{k-1}, the carry that enters segment k - 1.
__global__ void __launch_bounds__(kCarryThreads)
selective_scan_bwd_carry_kernel(Params p) {
  const int64_t i = (int64_t)blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= (int64_t)p.batch * p.D * kN) return;
  const int n = (int)(i % kN);
  const int64_t d = (i / kN) % p.D;
  const int64_t b = i / ((int64_t)kN * p.D);
  const int64_t n_carry = p.n_seg - 1;
  const float a_n = p.A[b * p.A_sb + d * kN + n];
  float GA = p.dlast != nullptr ? p.dlast[(b * p.D + d) * kN + n] : 0.f;
  float* g_p = p.gbuf + (b * n_carry * p.D + d) * kN + n;
  const float* s_p = p.sbuf + b * n_carry * p.D + d;
  for (int64_t k = n_carry - 1; k >= 0; --k) {
    GA = fmaf(expf(a_n * s_p[k * p.D]), GA, g_p[k * p.D * kN]);
    g_p[k * p.D * kN] = GA;
  }
}

// Pass C: segment blockIdx.y walked from the carry that enters it.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
selective_scan_bwd_kernel(Params p) {
  __shared__ float s_u[kChunk][kCh], s_dt[kChunk][kCh], s_sig[kChunk][kCh];
  __shared__ float s_dy[kChunk][kCh], s_du[kChunk][kCh], s_dd[kChunk][kCh];
  __shared__ float s_B[kChunk][kN], s_C[kChunk][kN];
  __shared__ float s_dB[kWarps][kChunk][kN], s_dC[kWarps][kChunk][kN];

  const int tid = threadIdx.x;
  const int n = tid % kN;
  const int c = tid / kN;                     // channel within the block
  const int warp = tid / 32;
  const int blk = blockIdx.x;
  const int seg = blockIdx.y;
  const int d = blk * kCh + c;
  const int64_t b = blockIdx.z;
  const bool live = d < p.D;
  const int dc = live ? d : 0;  // dead lanes address channel 0, store nothing
  const int64_t n_chunks = (p.L + kChunk - 1) / kChunk;
  const int64_t seg_chunks = p.l_seg / kChunk;
  const int64_t k_lo = seg * seg_chunks;
  const int64_t k_hi =
      k_lo + seg_chunks < n_chunks ? k_lo + seg_chunks : n_chunks;

  const float a_n = live ? p.A[b * p.A_sb + (int64_t)dc * kN + n] : 0.f;
  const float dsk = live ? p.Dskip[b * p.D_sb + dc] : 0.f;
  // carry: a_{t+1} g_{t+1}, seeded with the cotangent of the last state in
  // the last segment and with pass B's GA_k in the others
  float ga = 0.f;
  if (live) {
    if (seg < p.n_seg - 1)
      ga = p.gbuf[((b * (p.n_seg - 1) + seg) * p.D + dc) * kN + n];
    else if (p.dlast != nullptr)
      ga = p.dlast[(b * p.D + dc) * kN + n];
  }
  float dA = 0.f, dD = 0.f, dbias = 0.f;

  // the (t, channel) and (t, n) that this thread stages
  const int st_i = tid / kCh, st_c = tid % kCh, st_d = blk * kCh + st_c;
  const bool st_live = st_d < p.D;
  const float st_bias = st_live ? p.bias[b * p.bias_sb + st_d] : 0.f;
  const int sn_i = tid / kN, sn_n = tid % kN;
  const T* u_p = static_cast<const T*>(p.u) + b * p.u_sb + st_d;
  const T* dl_p = static_cast<const T*>(p.delta) + b * p.dl_sb + st_d;
  const T* dy_p = static_cast<const T*>(p.dy) + b * p.dy_sb + st_d;
  const T* B_p = static_cast<const T*>(p.B) + b * p.B_sb + sn_n;
  const T* C_p = static_cast<const T*>(p.C) + b * p.C_sb + sn_n;
  T* du_p = static_cast<T*>(p.du) + b * p.L * p.D + st_d;
  T* dd_p = static_cast<T*>(p.ddelta) + b * p.L * p.D + st_d;

  for (int64_t k = k_hi - 1; k >= k_lo; --k) {
    const int t0 = (int)k * kChunk;
    __syncthreads();  // the previous chunk's staged values are consumed
    {
      const int t = t0 + st_i;
      const bool ok = st_live && t < p.L;
      const float raw = ok ? to_f(dl_p[t * p.dl_sl]) + st_bias : 0.f;
      s_u[st_i][st_c] = ok ? to_f(u_p[t * p.u_sl]) : 0.f;
      // dt = 0 past L: a = 1, no input
      s_dt[st_i][st_c] = ok ? step_dt(raw, p.softplus) : 0.f;
      s_sig[st_i][st_c] = p.softplus ? 1.f / (1.f + expf(-raw)) : 1.f;
      s_dy[st_i][st_c] = ok ? to_f(dy_p[t * p.dy_sl]) : 0.f;
      const int tn = t0 + sn_i;
      s_B[sn_i][sn_n] = tn < p.L ? to_f(B_p[tn * p.B_sl]) : 0.f;
      s_C[sn_i][sn_n] = tn < p.L ? to_f(C_p[tn * p.C_sl]) : 0.f;
    }
    __syncthreads();

    // recompute the chunk's states forward from its saved start state
    const float h_start =
        live ? p.cs[((b * n_chunks + k) * p.D + dc) * kN + n] : 0.f;
    float h[kChunk];
    float hp = h_start;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const float dt = s_dt[i][c];
      hp = expf(dt * a_n) * hp + dt * s_u[i][c] * s_B[i][n];
      h[i] = hp;
    }

    // walk the chunk backward
#pragma unroll
    for (int i = kChunk - 1; i >= 0; --i) {
      if (t0 + i >= p.L) continue;  // uniform over the block
      const float dt = s_dt[i][c], u = s_u[i][c], dy = s_dy[i][c];
      const float a = expf(dt * a_n);
      const float g = ga + s_C[i][n] * dy;
      const float h_prev = i > 0 ? h[i - 1] : h_start;
      const float gB = half_warp_sum(g * s_B[i][n]);
      const float dla = g * h_prev * a;
      const float dlaA = half_warp_sum(dla * a_n);
      const float dd = (u * gB + dlaA) * s_sig[i][c];
      if (n == 0) {
        s_du[i][c] = dt * gB + dsk * dy;
        s_dd[i][c] = dd;
      }
      dA += dla * dt;
      dD += dy * u;
      dbias += dd;
      float vB = g * dt * u, vC = h[i] * dy;  // zero on dead channels
      vB += __shfl_xor_sync(0xffffffffu, vB, kN);
      vC += __shfl_xor_sync(0xffffffffu, vC, kN);
      if ((tid & 31) < kN) {
        s_dB[warp][i][n] = vB;
        s_dC[warp][i][n] = vC;
      }
      ga = a * g;
    }
    __syncthreads();

    // du / ddelta of the chunk, coalesced along d
    {
      const int t = t0 + st_i;
      if (st_live && t < p.L) {
        du_p[(int64_t)t * p.D] = from_f<T>(s_du[st_i][st_c]);
        dd_p[(int64_t)t * p.D] = from_f<T>(s_dd[st_i][st_c]);
      }
    }
    // this block's dB / dC partial sums over its channels
    {
      const int t = t0 + sn_i;
      if (t < p.L) {
        float sB = 0.f, sC = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          sB += s_dB[w][sn_i][sn_n];
          sC += s_dC[w][sn_i][sn_n];
        }
        const int64_t row = (int64_t)p.batch * p.L * kN;
        const int64_t at = (b * p.L + t) * kN + sn_n;
        p.part[(2 * (int64_t)blk) * row + at] = sB;
        p.part[(2 * (int64_t)blk + 1) * row + at] = sC;
      }
    }
  }

  if (live) {
    const int64_t at = ((int64_t)seg * p.batch + b) * p.D + d;
    p.pdA[at * kN + n] = dA;
    // = a_0 g_0 after the leftmost chunk
    if (seg == 0) p.dh0[(b * p.D + d) * kN + n] = ga;
    if (n == 0) {
      p.pdD[at] = dD;
      p.pdbias[at] = dbias;
    }
  }
}

// Pass D: dB, dC (batch, L, N) in T, the blocks' partials summed in block
// order.
template <typename T>
__global__ void sum_partials_kernel(const float* part, T* dB, T* dC,
                                    int n_blocks, int64_t row) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * row) return;
  const int which = (int)(i / row);
  const int64_t at = i % row;
  float s = 0.f;
  for (int blk = 0; blk < n_blocks; ++blk)
    s += part[(2 * (int64_t)blk + which) * row + at];
  (which == 0 ? dB : dC)[at] = from_f<T>(s);
}

// Pass D: dA, then dD, then dbias, the segments' partials summed in segment
// order.
__global__ void selective_scan_bwd_sum_params_kernel(Params p) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nA = (int64_t)p.batch * p.D * kN, nD = (int64_t)p.batch * p.D;
  const float* src;
  float* dst;
  int64_t j, size;
  if (i < nA) {
    src = p.pdA, dst = p.dA, j = i, size = nA;
  } else if (i < nA + nD) {
    src = p.pdD, dst = p.dD, j = i - nA, size = nD;
  } else if (i < nA + 2 * nD) {
    src = p.pdbias, dst = p.dbias, j = i - nA - nD, size = nD;
  } else {
    return;
  }
  float s = 0.f;
  for (int seg = 0; seg < p.n_seg; ++seg) s += src[seg * size + j];
  dst[j] = s;
}

template <typename T>
cudaError_t launch(const Params& p, void* dB, void* dC, cudaStream_t stream) {
  const int n_blocks = (p.D + kCh - 1) / kCh;
  cudaError_t err;
  if (p.n_seg > 1) {
    selective_scan_bwd_local_kernel<T><<<dim3(n_blocks, p.n_seg - 1, p.batch),
                                         kThreads, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t states = (int64_t)p.batch * p.D * kN;
    selective_scan_bwd_carry_kernel<<<
        (unsigned)((states + kCarryThreads - 1) / kCarryThreads),
        kCarryThreads, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  selective_scan_bwd_kernel<T><<<dim3(n_blocks, p.n_seg, p.batch), kThreads,
                                 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const int64_t row = (int64_t)p.batch * p.L * kN;
  const int64_t grid = (2 * row + threads - 1) / threads;
  if (grid > 0) {
    sum_partials_kernel<T><<<(unsigned)grid, threads, 0, stream>>>(
        p.part, static_cast<T*>(dB), static_cast<T*>(dC), n_blocks, row);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.n_seg > 1) {
    const int64_t params = (int64_t)p.batch * p.D * (kN + 2);
    selective_scan_bwd_sum_params_kernel<<<
        (unsigned)((params + threads - 1) / threads), threads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32 scratch elements that vivim_selective_scan_bwd needs for this shape
// and segment length (the dB / dC partials, and with more than one segment
// the carries, the segments' dt sums and the parameter-grad partials), or -1
// when `l_seg` is not a positive multiple of kChunk.
int64_t vivim_selective_scan_bwd_scratch(int batch, int L, int D, int l_seg) {
  if (l_seg <= 0 || l_seg % kChunk != 0) return -1;
  return layout(batch, L, D, (int)segments(L, l_seg)).total;
}

// Channels per block: the grid's first dimension is ceil(D / this), and the
// wrapper picks l_seg from it.
int vivim_selective_scan_bwd_channels(void) { return kCh; }

// dtype: 0 = float32, 1 = bfloat16 (u, delta, B, C, dy and the sequence
// grads share it).  A, Dskip, bias, cs, dlast and the parameter grads are
// fp32; dlast may be null.  ddelta, du (batch, L, D) and dB, dC (batch, L, N)
// are written contiguous.  `chunk` must equal kChunk; `l_seg`, a multiple of
// it, is the segment length, and `scratch` holds
// vivim_selective_scan_bwd_scratch(batch, L, D, l_seg) fp32 elements.
// Returns cudaGetLastError() after the launches (0 = success).
int vivim_selective_scan_bwd(
    const void* u, const void* delta, const void* B, const void* C,
    const void* dy, const void* A, const void* Dskip, const void* bias,
    const void* cs, const void* dlast, void* ddelta, void* du, void* dB,
    void* dC, void* dA, void* dD, void* dbias, void* dh0, void* scratch,
    int chunk, int l_seg, int batch, int L, int D, int64_t u_sb, int64_t u_sl,
    int64_t dl_sb, int64_t dl_sl, int64_t B_sb, int64_t B_sl, int64_t C_sb,
    int64_t C_sl, int64_t dy_sb, int64_t dy_sl, int64_t A_sb, int64_t D_sb,
    int64_t bias_sb, int softplus, int dtype, void* stream) {
  if (chunk != kChunk || l_seg <= 0 || l_seg % kChunk != 0 || L < 0 ||
      D <= 0 || batch <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t n_seg = segments(L, l_seg);
  if (n_seg > 65535) return (int)cudaErrorInvalidValue;
  const Layout s = layout(batch, L, D, (int)n_seg);
  float* base = static_cast<float*>(scratch);
  Params p;
  p.u = u;
  p.delta = delta;
  p.B = B;
  p.C = C;
  p.dy = dy;
  p.A = static_cast<const float*>(A);
  p.Dskip = static_cast<const float*>(Dskip);
  p.bias = static_cast<const float*>(bias);
  p.cs = static_cast<const float*>(cs);
  p.dlast = static_cast<const float*>(dlast);
  p.ddelta = ddelta;
  p.du = du;
  p.dA = static_cast<float*>(dA);
  p.dD = static_cast<float*>(dD);
  p.dbias = static_cast<float*>(dbias);
  p.dh0 = static_cast<float*>(dh0);
  p.part = base + s.part;
  p.gbuf = base + s.gbuf;
  p.sbuf = base + s.sbuf;
  const bool one = n_seg == 1;
  p.pdA = one ? p.dA : base + s.pdA;
  p.pdD = one ? p.dD : base + s.pdD;
  p.pdbias = one ? p.dbias : base + s.pdbias;
  p.batch = batch;
  p.L = L;
  p.D = D;
  p.l_seg = l_seg;
  p.n_seg = (int)n_seg;
  p.u_sb = u_sb;
  p.u_sl = u_sl;
  p.dl_sb = dl_sb;
  p.dl_sl = dl_sl;
  p.B_sb = B_sb;
  p.B_sl = B_sl;
  p.C_sb = C_sb;
  p.C_sl = C_sl;
  p.dy_sb = dy_sb;
  p.dy_sl = dy_sl;
  p.A_sb = A_sb;
  p.D_sb = D_sb;
  p.bias_sb = bias_sb;
  p.softplus = softplus;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, dB, dC, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, dB, dC, st);
  return (int)cudaErrorInvalidValue;
}

const char* vivim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
