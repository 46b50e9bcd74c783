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
// The state dimension N is any value from 1 to kMaxN = 256, as in
// selective_scan_fwd.cu.
//
// Design.  A channel's states are held by kLN lanes of one warp, each lane
// holding kS states (n = s * kLN + lane for s < kS), so that a channel holds
// kNp = kLN * kS >= N states, the ones at or past N masked (A, B, C, the
// chunk state and dlast read as 0: such a state's adjoint stays 0 and adds
// nothing).  The family is picked from N: kLN = 1, 2, 4, 8 or 16 lanes of
// one state for N <= 16 (N = 16 is 16 lanes x 1 state, a half warp per
// channel), and 16 lanes of kS = 2, 4, 8 or 16 states for 16 < N <= 256.
// A block holds kCh channels (kCh x kLN threads: 64 of 1 lane, 64 of 2 or
// of 4 lanes, 32 of 8, 16 of 16, and 8 at N > 128, which keeps the staged
// B and C in 48 KB of static shared memory).  The main kernel walks chunks
// of kChunk steps from right to left.  For each chunk it stages the chunk's
// u, dt, sigmoid, dy (per channel) and B, C (per n) in shared memory with
// coalesced loads; then, one state of its kS at a time, a lane recomputes h
// forward from the saved chunk-start state into kChunk registers (the
// recurrence is never inverted: a underflows) and walks the chunk backward
// carrying that state's ga = a_{t+1} g_{t+1} in a register.  With one state
// per lane, du and ddelta's sums over n are log2(kLN) xor shuffles inside
// the walk; with kS states, each lane adds its states' shares into kChunk
// per-step registers first and shuffles once after the last state.
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
// channels (log2(32 / kLN) xor shuffles across the channels of a warp, none
// when a channel fills it, then shared memory across its warps, one state
// of each lane at a time) and writes one fp32 partial per (block, b, t, n);
// segments split t, so each partial is written once.  Nothing uses atomics,
// so the result is deterministic.  Ragged L, d and N are masked; nothing is
// padded.  The wrapper allocates one fp32 scratch buffer, which
// vivim_selective_scan_bwd_scratch() sizes and `layout` cuts.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  The function must read u, delta,
// dy (3 * L * D), B and C (2 * L * N) and the chunk states, and write ddelta
// and du (2 * L * D) and dB and dC (2 * L * N).  At Vivim-b3's training stage
// 0 (batch 9 = 3 directions x 3 clips, L = 20480, D = 128, fp32, N = 16)
// that is about 0.61 GB, about 0.18 ms (0.09 GB of it the chunk states, one
// per kChunk = 16 steps).  Its arithmetic (the recompute and the adjoint,
// about 21 operations per state and step, an exp counted as one, plus about
// 20 per channel and step) is about 8.4 GFLOP, 0.13 ms at the 67 TFLOP/s of
// fp32 outside the tensor cores: the two bounds are close, and the
// operations grow with N.
//
// Expected weakness: each block still walks its segment in sequence, one
// chunk at a time, with three __syncthreads (two more per further state of
// a lane) and two shuffle reductions per step, so the kernel is
// latency-bound; the segments only put more blocks in flight.  Pass A reads
// delta, C and dy a second time, and the partials add 2 * N * 4 bytes per
// (block, b, t) of traffic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 256;              // the largest d_state
constexpr int kChunk = 16;              // = selective_scan_fwd.cu's kChunk
constexpr int kCarryThreads = 64;

// kLN_ lanes per channel, kS_ states per lane; kExactN_ > 0 fixes N at
// compile time (N = 16, whose masks and index arithmetic then fold away),
// 0 reads it from the launch.
template <int kLN_, int kS_, int kExactN_ = 0>
struct Family {
  static constexpr int kLN = kLN_;
  static constexpr int kS = kS_;
  static constexpr int kExactN = kExactN_;
  static constexpr int kNp = kLN * kS;          // states held per channel
  // channels per block; the wrapper reads it through
  // vivim_selective_scan_bwd_channels(N) to size the grid and pick l_seg
  static constexpr int kCh =
      kLN == 16 ? (kS == 16 ? 8 : 16) : (kLN == 8 ? 32 : 64);
  static constexpr int kThreads = kLN * kCh;
  static constexpr int kWarps = kThreads / 32;
  // blocks per SM: 4 caps a 256-thread block's registers at 64 (N <= 16);
  // a lane of several states holds their carries, decays and dA and the
  // per-step sums, and gets 128 (255 at 128 threads)
  static constexpr int kMinBlocks = kS == 1 ? 4 : 2;
  static_assert(kThreads % 32 == 0 && 32 % kLN == 0, "whole warps");
  static_assert((kChunk * kCh) % kThreads == 0, "whole staging rounds");
  static_assert(kExactN == 0 || kExactN == kNp, "an exact N fills the lanes");
  // N: the compile-time one, or the launch's
  static __device__ __forceinline__ int n(int N) {
    return kExactN ? kExactN : N;
  }
};

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
  int batch, L, D, N, l_seg, n_seg;
  int64_t u_sb, u_sl, dl_sb, dl_sl, B_sb, B_sl, C_sb, C_sl, dy_sb, dy_sl;
  int64_t A_sb, D_sb, bias_sb;
  int softplus;
};

// Calls fn(Family<kLN, kS>()) for the family that holds N states.
template <class Fn>
auto with_family(int N, Fn&& fn) {
  if (N == 16) return fn(Family<16, 1, 16>());
  if (N <= 1) return fn(Family<1, 1>());
  if (N <= 2) return fn(Family<2, 1>());
  if (N <= 4) return fn(Family<4, 1>());
  if (N <= 8) return fn(Family<8, 1>());
  if (N <= 16) return fn(Family<16, 1>());
  if (N <= 32) return fn(Family<16, 2>());
  if (N <= 64) return fn(Family<16, 4>());
  if (N <= 128) return fn(Family<16, 8>());
  return fn(Family<16, 16>());
}

int channels(int N) {
  return with_family(N, [](auto f) { return decltype(f)::kCh; });
}

// Offsets (fp32 elements) of the pieces of the scratch buffer.
struct Layout {
  int64_t part, gbuf, sbuf, pdA, pdD, pdbias, total;
};

Layout layout(int batch, int L, int D, int N, int n_seg) {
  const int64_t bd = (int64_t)batch * D;
  const int64_t carries = n_seg > 1 ? n_seg - 1 : 0;
  const int64_t partials = n_seg > 1 ? n_seg : 0;
  const int ch = channels(N);
  Layout s;
  s.part = 0;
  s.gbuf = s.part + (int64_t)((D + ch - 1) / ch) * 2 * batch * L * N;
  s.sbuf = s.gbuf + carries * bd * N;
  s.pdA = s.sbuf + carries * bd;
  s.pdD = s.pdA + partials * bd * N;
  s.pdbias = s.pdD + partials * bd;
  s.total = s.pdbias + partials * bd;
  return s;
}

// Rounds of a block's threads that cover `count` staged entries.
__host__ __device__ constexpr int rounds(int count, int threads) {
  return (count + threads - 1) / threads;
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

// sum over the kLN lanes of a channel
template <int kLN>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int off = kLN / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum over the channels of a warp (lane kLN * c + l holds channel c)
template <int kLN>
__device__ __forceinline__ float channel_sum(float v) {
#pragma unroll
  for (int off = kLN; off < 32; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Pass A: segment blockIdx.y + 1 walked from a zero carry.
template <typename T, class F>
__global__ void __launch_bounds__(F::kThreads, F::kMinBlocks)
selective_scan_bwd_local_kernel(Params p) {
  constexpr int kLN = F::kLN, kS = F::kS, kCh = F::kCh;
  constexpr int kThreads = F::kThreads;
  __shared__ float s_dt[kChunk][kCh], s_dy[kChunk][kCh];
  __shared__ float s_C[kChunk][F::kNp];

  const int tid = threadIdx.x;
  const int ln = tid % kLN;
  const int c = tid / kLN;
  const int blk = blockIdx.x;
  const int seg = blockIdx.y + 1;
  const int64_t b = blockIdx.z;
  const int N = F::n(p.N);
  const int d = blk * kCh + c;
  const bool live = d < p.D;
  float a_n[kS], ga[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int n = s * kLN + ln;
    a_n[s] = live && n < N ? p.A[b * p.A_sb + (int64_t)d * N + n] : 0.f;
    ga[s] = 0.f;
  }

  // the channel this thread stages (the same in every round)
  const int st_c = tid % kCh, st_d = blk * kCh + st_c;
  const bool st_live = st_d < p.D;
  const float st_bias = st_live ? p.bias[b * p.bias_sb + st_d] : 0.f;
  const T* dl_p = static_cast<const T*>(p.delta) + b * p.dl_sb + st_d;
  const T* dy_p = static_cast<const T*>(p.dy) + b * p.dy_sb + st_d;
  const T* C_p = static_cast<const T*>(p.C) + b * p.C_sb;

  const int64_t seg_chunks = p.l_seg / kChunk;
  const int64_t k_lo = seg * seg_chunks;
  const int64_t n_chunks = (p.L + kChunk - 1) / kChunk;
  const int64_t k_hi =
      k_lo + seg_chunks < n_chunks ? k_lo + seg_chunks : n_chunks;
  float S = 0.f;
  for (int64_t k = k_hi - 1; k >= k_lo; --k) {
    const int t0 = (int)k * kChunk;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < rounds(kChunk * kCh, kThreads); ++j) {
      const int e = tid + j * kThreads;
      const int i = e / kCh, t = t0 + i;
      const bool ok = st_live && t < p.L;
      const float raw = ok ? to_f(dl_p[t * p.dl_sl]) + st_bias : 0.f;
      s_dt[i][st_c] = ok ? step_dt(raw, p.softplus) : 0.f;
      s_dy[i][st_c] = ok ? to_f(dy_p[t * p.dy_sl]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < rounds(kChunk * F::kNp, kThreads); ++j) {
      const int e = tid + j * kThreads;
      if ((kChunk * F::kNp) % kThreads != 0 && e >= kChunk * F::kNp) break;
      const int i = e / F::kNp, col = e % F::kNp, t = t0 + i;
      s_C[i][col] = t < p.L && col < N ? to_f(C_p[t * p.C_sl + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = kChunk - 1; i >= 0; --i) {
      if (t0 + i >= p.L) continue;  // uniform over the block
      const float dt = s_dt[i][c], dy = s_dy[i][c];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const float g = ga[s] + s_C[i][s * kLN + ln] * dy;
        ga[s] = expf(dt * a_n[s]) * g;
      }
      S += dt;
    }
  }
  if (live) {
    const int64_t slot = (b * (p.n_seg - 1) + seg - 1) * p.D + d;
#pragma unroll
    for (int s = 0; s < kS; ++s)
      if (s * kLN + ln < N) p.gbuf[slot * N + s * kLN + ln] = ga[s];
    if (ln == 0) p.sbuf[slot] = S;
  }
}

// Pass B: one thread per (b, d, n) carries ga over the segments, right to
// left.  Slot k - 1 of gbuf / sbuf holds segment k's gloc_k / S_k and takes
// GA_{k-1}, the carry that enters segment k - 1.
template <class F>
__global__ void __launch_bounds__(kCarryThreads)
selective_scan_bwd_carry_kernel(Params p) {
  const int64_t i = (int64_t)blockIdx.x * kCarryThreads + threadIdx.x;
  const int N = F::n(p.N);
  if (i >= (int64_t)p.batch * p.D * N) return;
  const int n = (int)(i % N);
  const int64_t d = (i / N) % p.D;
  const int64_t b = i / ((int64_t)N * p.D);
  const int64_t n_carry = p.n_seg - 1;
  const float a_n = p.A[b * p.A_sb + d * N + n];
  float GA = p.dlast != nullptr ? p.dlast[(b * p.D + d) * N + n] : 0.f;
  float* g_p = p.gbuf + (b * n_carry * p.D + d) * N + n;
  const float* s_p = p.sbuf + b * n_carry * p.D + d;
  for (int64_t k = n_carry - 1; k >= 0; --k) {
    GA = fmaf(expf(a_n * s_p[k * p.D]), GA, g_p[k * p.D * N]);
    g_p[k * p.D * N] = GA;
  }
}

// Pass C: segment blockIdx.y walked from the carry that enters it.
template <typename T, class F>
__global__ void __launch_bounds__(F::kThreads, F::kMinBlocks)
selective_scan_bwd_kernel(Params p) {
  constexpr int kLN = F::kLN, kS = F::kS, kCh = F::kCh, kNp = F::kNp;
  constexpr int kThreads = F::kThreads, kWarps = F::kWarps;
  __shared__ float s_u[kChunk][kCh], s_dt[kChunk][kCh], s_sig[kChunk][kCh];
  __shared__ float s_dy[kChunk][kCh], s_du[kChunk][kCh], s_dd[kChunk][kCh];
  __shared__ float s_B[kChunk][kNp], s_C[kChunk][kNp];
  __shared__ float s_dB[kWarps][kChunk][kLN], s_dC[kWarps][kChunk][kLN];

  const int tid = threadIdx.x;
  const int ln = tid % kLN;                   // lane within the channel
  const int c = tid / kLN;                    // channel within the block
  const int warp = tid / 32;
  const int blk = blockIdx.x;
  const int seg = blockIdx.y;
  const int d = blk * kCh + c;
  const int64_t b = blockIdx.z;
  const int N = F::n(p.N);
  const bool live = d < p.D;
  const int dc = live ? d : 0;  // dead lanes address channel 0, store nothing
  const int64_t n_chunks = (p.L + kChunk - 1) / kChunk;
  const int64_t seg_chunks = p.l_seg / kChunk;
  const int64_t k_lo = seg * seg_chunks;
  const int64_t k_hi =
      k_lo + seg_chunks < n_chunks ? k_lo + seg_chunks : n_chunks;

  // per state s of this lane (n = s * kLN + ln): its A, its carry
  // a_{t+1} g_{t+1} (seeded with the cotangent of the last state in the
  // last segment and with pass B's GA_k in the others) and its dA
  float a_n[kS], ga[kS], dA[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int n = s * kLN + ln;
    const bool ok = live && n < N;
    a_n[s] = ok ? p.A[b * p.A_sb + (int64_t)dc * N + n] : 0.f;
    ga[s] = 0.f;
    if (ok) {
      if (seg < p.n_seg - 1)
        ga[s] = p.gbuf[((b * (p.n_seg - 1) + seg) * p.D + dc) * N + n];
      else if (p.dlast != nullptr)
        ga[s] = p.dlast[(b * p.D + dc) * N + n];
    }
    dA[s] = 0.f;
  }
  const float dsk = live ? p.Dskip[b * p.D_sb + dc] : 0.f;
  float dD = 0.f, dbias = 0.f;

  // the channel this thread stages (the same in every round)
  const int st_c = tid % kCh, st_d = blk * kCh + st_c;
  const bool st_live = st_d < p.D;
  const float st_bias = st_live ? p.bias[b * p.bias_sb + st_d] : 0.f;
  const T* u_p = static_cast<const T*>(p.u) + b * p.u_sb + st_d;
  const T* dl_p = static_cast<const T*>(p.delta) + b * p.dl_sb + st_d;
  const T* dy_p = static_cast<const T*>(p.dy) + b * p.dy_sb + st_d;
  const T* B_p = static_cast<const T*>(p.B) + b * p.B_sb;
  const T* C_p = static_cast<const T*>(p.C) + b * p.C_sb;
  T* du_p = static_cast<T*>(p.du) + b * p.L * p.D + st_d;
  T* dd_p = static_cast<T*>(p.ddelta) + b * p.L * p.D + st_d;
  const int64_t row = (int64_t)p.batch * p.L * N;

  for (int64_t k = k_hi - 1; k >= k_lo; --k) {
    const int t0 = (int)k * kChunk;
    __syncthreads();  // the previous chunk's staged values are consumed
#pragma unroll
    for (int j = 0; j < rounds(kChunk * kCh, kThreads); ++j) {
      const int e = tid + j * kThreads;
      const int i = e / kCh, t = t0 + i;
      const bool ok = st_live && t < p.L;
      const float raw = ok ? to_f(dl_p[t * p.dl_sl]) + st_bias : 0.f;
      s_u[i][st_c] = ok ? to_f(u_p[t * p.u_sl]) : 0.f;
      // dt = 0 past L: a = 1, no input
      s_dt[i][st_c] = ok ? step_dt(raw, p.softplus) : 0.f;
      s_sig[i][st_c] = p.softplus ? 1.f / (1.f + expf(-raw)) : 1.f;
      s_dy[i][st_c] = ok ? to_f(dy_p[t * p.dy_sl]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < rounds(kChunk * kNp, kThreads); ++j) {
      const int e = tid + j * kThreads;
      if ((kChunk * kNp) % kThreads != 0 && e >= kChunk * kNp) break;
      const int i = e / kNp, col = e % kNp, t = t0 + i;
      const bool ok = t < p.L && col < N;
      s_B[i][col] = ok ? to_f(B_p[t * p.B_sl + col]) : 0.f;
      s_C[i][col] = ok ? to_f(C_p[t * p.C_sl + col]) : 0.f;
    }
    __syncthreads();

    // this lane's shares of sum_n g B and sum_n g h_{t-1} a A per step
    // (several states per lane only)
    float gB_s[kChunk], dlaA_s[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) gB_s[i] = dlaA_s[i] = 0.f;

#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int n = s * kLN + ln;
      // recompute the chunk's states forward from its saved start state
      const float h_start =
          live && n < N ? p.cs[((b * n_chunks + k) * p.D + dc) * N + n]
                        : 0.f;
      float h[kChunk];
      float hp = h_start;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float dt = s_dt[i][c];
        hp = expf(dt * a_n[s]) * hp + dt * s_u[i][c] * s_B[i][n];
        h[i] = hp;
      }

      // walk the chunk backward
#pragma unroll
      for (int i = kChunk - 1; i >= 0; --i) {
        if (t0 + i >= p.L) continue;  // uniform over the block
        const float dt = s_dt[i][c], u = s_u[i][c], dy = s_dy[i][c];
        const float a = expf(dt * a_n[s]);
        const float g = ga[s] + s_C[i][n] * dy;
        const float h_prev = i > 0 ? h[i - 1] : h_start;
        const float dla = g * h_prev * a;
        if (kS == 1) {
          const float gB = lane_sum<kLN>(g * s_B[i][n]);
          const float dlaA = lane_sum<kLN>(dla * a_n[s]);
          const float dd = (u * gB + dlaA) * s_sig[i][c];
          if (ln == 0) {
            s_du[i][c] = dt * gB + dsk * dy;
            s_dd[i][c] = dd;
          }
          dD += dy * u;
          dbias += dd;
        } else {
          gB_s[i] = fmaf(g, s_B[i][n], gB_s[i]);
          dlaA_s[i] = fmaf(dla, a_n[s], dlaA_s[i]);
        }
        dA[s] += dla * dt;
        // zero on dead channels and masked states
        const float vB = channel_sum<kLN>(g * dt * u);
        const float vC = channel_sum<kLN>(h[i] * dy);
        if ((tid & 31) < kLN) {
          s_dB[warp][i][ln] = vB;
          s_dC[warp][i][ln] = vC;
        }
        ga[s] = a * g;
      }
      __syncthreads();

      // this block's dB / dC partial sums over its channels, for the
      // states s * kLN .. s * kLN + kLN - 1
#pragma unroll
      for (int j = 0; j < rounds(kChunk * kLN, kThreads); ++j) {
        const int e = tid + j * kThreads;
        if ((kChunk * kLN) % kThreads != 0 && e >= kChunk * kLN) break;
        const int i = e / kLN, nn = s * kLN + e % kLN, t = t0 + i;
        if (t < p.L && nn < N) {
          float sB = 0.f, sC = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) {
            sB += s_dB[w][i][e % kLN];
            sC += s_dC[w][i][e % kLN];
          }
          const int64_t at = (b * p.L + t) * N + nn;
          p.part[(2 * (int64_t)blk) * row + at] = sB;
          p.part[(2 * (int64_t)blk + 1) * row + at] = sC;
        }
      }
      // the next state's walk overwrites s_dB / s_dC
      if (s + 1 < kS) __syncthreads();
    }

    if (kS > 1) {  // du / ddelta from the lanes' shares
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (t0 + i >= p.L) continue;  // uniform over the block
        const float dt = s_dt[i][c], u = s_u[i][c], dy = s_dy[i][c];
        const float gB = lane_sum<kLN>(gB_s[i]);
        const float dlaA = lane_sum<kLN>(dlaA_s[i]);
        const float dd = (u * gB + dlaA) * s_sig[i][c];
        if (ln == 0) {
          s_du[i][c] = dt * gB + dsk * dy;
          s_dd[i][c] = dd;
        }
        dD += dy * u;
        dbias += dd;
      }
      __syncthreads();
    }

    // du / ddelta of the chunk, coalesced along d
#pragma unroll
    for (int j = 0; j < rounds(kChunk * kCh, kThreads); ++j) {
      const int e = tid + j * kThreads;
      const int i = e / kCh, t = t0 + i;
      if (st_live && t < p.L) {
        du_p[(int64_t)t * p.D] = from_f<T>(s_du[i][st_c]);
        dd_p[(int64_t)t * p.D] = from_f<T>(s_dd[i][st_c]);
      }
    }
  }

  if (live) {
    const int64_t at = ((int64_t)seg * p.batch + b) * p.D + d;
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int n = s * kLN + ln;
      if (n >= N) continue;
      p.pdA[at * N + n] = dA[s];
      // = a_0 g_0 after the leftmost chunk
      if (seg == 0) p.dh0[(b * p.D + d) * N + n] = ga[s];
    }
    if (ln == 0) {
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
  const int64_t nA = (int64_t)p.batch * p.D * p.N;
  const int64_t nD = (int64_t)p.batch * p.D;
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

template <typename T, class F>
cudaError_t launch(const Params& p, void* dB, void* dC, cudaStream_t stream) {
  const int n_blocks = (p.D + F::kCh - 1) / F::kCh;
  cudaError_t err;
  if (p.n_seg > 1) {
    selective_scan_bwd_local_kernel<T, F><<<
        dim3(n_blocks, p.n_seg - 1, p.batch), F::kThreads, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t states = (int64_t)p.batch * p.D * p.N;
    selective_scan_bwd_carry_kernel<F><<<
        (unsigned)((states + kCarryThreads - 1) / kCarryThreads),
        kCarryThreads, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  selective_scan_bwd_kernel<T, F><<<dim3(n_blocks, p.n_seg, p.batch),
                                    F::kThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const int64_t row = (int64_t)p.batch * p.L * p.N;
  const int64_t grid = (2 * row + threads - 1) / threads;
  if (grid > 0) {
    sum_partials_kernel<T><<<(unsigned)grid, threads, 0, stream>>>(
        p.part, static_cast<T*>(dB), static_cast<T*>(dC), n_blocks, row);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.n_seg > 1) {
    const int64_t params = (int64_t)p.batch * p.D * (p.N + 2);
    selective_scan_bwd_sum_params_kernel<<<
        (unsigned)((params + threads - 1) / threads), threads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32 scratch elements that vivim_selective_scan_bwd needs for this shape,
// state dimension and segment length (the dB / dC partials, and with more
// than one segment the carries, the segments' dt sums and the
// parameter-grad partials), or -1 when `l_seg` is not a positive multiple
// of kChunk or N is outside 1 to 256.
int64_t vivim_selective_scan_bwd_scratch(int batch, int L, int D, int N,
                                         int l_seg) {
  if (l_seg <= 0 || l_seg % kChunk != 0 || N < 1 || N > kMaxN) return -1;
  return layout(batch, L, D, N, (int)segments(L, l_seg)).total;
}

// Channels per block at state dimension N (1 to 256; 0 outside it): the
// grid's first dimension is ceil(D / this), and the wrapper picks l_seg
// from it.
int vivim_selective_scan_bwd_channels(int N) {
  if (N < 1 || N > kMaxN) return 0;
  return channels(N);
}

// dtype: 0 = float32, 1 = bfloat16 (u, delta, B, C, dy and the sequence
// grads share it).  A, Dskip, bias, cs, dlast and the parameter grads are
// fp32; dlast may be null.  ddelta, du (batch, L, D) and dB, dC (batch, L, N)
// are written contiguous; N is 1 to 256.  `chunk` must equal kChunk;
// `l_seg`, a multiple of it, is the segment length, and `scratch` holds
// vivim_selective_scan_bwd_scratch(batch, L, D, N, l_seg) fp32 elements.
// Returns cudaGetLastError() after the launches (0 = success).
int vivim_selective_scan_bwd(
    const void* u, const void* delta, const void* B, const void* C,
    const void* dy, const void* A, const void* Dskip, const void* bias,
    const void* cs, const void* dlast, void* ddelta, void* du, void* dB,
    void* dC, void* dA, void* dD, void* dbias, void* dh0, void* scratch,
    int chunk, int l_seg, int batch, int L, int D, int N, int64_t u_sb,
    int64_t u_sl, int64_t dl_sb, int64_t dl_sl, int64_t B_sb, int64_t B_sl,
    int64_t C_sb, int64_t C_sl, int64_t dy_sb, int64_t dy_sl, int64_t A_sb,
    int64_t D_sb, int64_t bias_sb, int softplus, int dtype, void* stream) {
  if (chunk != kChunk || l_seg <= 0 || l_seg % kChunk != 0 || L < 0 ||
      D <= 0 || N < 1 || N > kMaxN || batch <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t n_seg = segments(L, l_seg);
  if (n_seg > 65535) return (int)cudaErrorInvalidValue;
  const Layout s = layout(batch, L, D, N, (int)n_seg);
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
  p.N = N;
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
  return with_family(N, [&](auto f) {
    using F = decltype(f);
    if (dtype == 0) return (int)launch<float, F>(p, dB, dC, st);
    if (dtype == 1) return (int)launch<__nv_bfloat16, F>(p, dB, dC, st);
    return (int)cudaErrorInvalidValue;
  });
}

const char* vivim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
