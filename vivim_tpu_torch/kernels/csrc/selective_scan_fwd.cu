// Selective-scan (Mamba S6) forward for Hopper (sm_90a): a chunk-parallel scan.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// the JAX package's kernels/selective_scan.py:174-219 (launched by `_fwd_call`,
// pl.pallas_call at :390) in both of its variants:
// - inference (`save_cs=False`): silu(z) gate inside the kernel;
// - training (`save_cs=True`, `has_z=False`): no z; the state *before*
//   every kChunk-th step is written out in fp32 (chunk-start states,
//   (batch, ceil(L / kChunk), D, N)) for the backward kernel
//   (selective_scan_bwd.cu), which recomputes h inside each chunk from them.
// For every (b, d, n):
//
//   dt_t = softplus(delta_t + bias)                (when `softplus` is set)
//   h_t  = exp(dt_t * A) * h_{t-1} + dt_t * u_t * B_t     h_0 = h0 or 0, fp32
//   y_t  = sum_n C_t * h_t + D * u_t
//   out  = y * silu(z)                             (when z is given)
//
// `out` is written in the input dtype, the last state (B, D, N) in fp32.
//
// Design.  One thread owns one channel d and holds its N = 16 states and
// A * log2(e) in registers.  The layout is time-major (batch, L, D) with D
// contiguous, so a warp of 32 channels reads u, delta and z and writes y
// coalesced (128 bytes per step in fp32).  Per step a thread computes
// dt = softplus(delta + bias) once, each state's decay as one ex2 (MUFU) of
// dt * A * log2(e), and y = sum_n C_n h_n in its own registers: no shuffles.
// B and C, shared by every channel, are staged per kTile steps in shared
// memory (double-buffered, coalesced loads from their strided rows) and read
// as broadcasts.  u, delta and z are prefetched kSub steps ahead in
// registers.
//
// L is split into chunks of `l_chunk` steps (a multiple of kChunk chosen by
// the wrapper per shape so that the grid has a few blocks per SM); the grid
// is (ceil(D / kThreads) channel tiles, chunks, batch).  Three passes:
//   A (chunk kernel, kLocal): every chunk but the last walks its steps
//     from a zero state and writes its local end state hloc_k and
//     S_k = sum_t dt_t to the scratch `hbuf` / `sbuf`;
//   B (carry kernel): one thread per (b, d, n) walks the chunks in order,
//     H_0 = h0 or 0, H_{k+1} = exp(A * S_k) * H_k + hloc_k, and writes
//     H_{k+1} over hloc_k: the start state of chunk k + 1;
//   C (chunk kernel, kOut): every chunk re-walks its steps from its
//     start state (h0 or 0 for the first), writes y (gated by silu(z) in the
//     inference variant), the chunk-start state before every kChunk-th step
//     in the training variant, and, in the last chunk, the last state.
// With one chunk, passes A and B are skipped.  Ragged D is masked (dead
// channels compute on zeros and store nothing); ragged L shortens the last
// chunk; nothing is padded.  The wrapper allocates the scratch.
//
// Bounds on an H100 SXM (3.35 TB/s HBM3; 16 MUFU ops per clock per SM x 132
// SMs x 1.98 GHz = 4.2 T ex2/s).  Bytes: the function must read u, delta, z,
// B and C once and write y once, (4 * D + 2 * N) * L * batch * size(T):
// 133.7 MB, 40 us, at Vivim-b3's serving stage 0 (batch 3 = three scan
// directions, L = 20480, D = 128, fp32).  Exps: one per state and step,
// batch * L * D * N = 126 M there, 30 us.  fp32 arithmetic (about six
// operations per state and step outside the exp) is 0.75 GFLOP, 11 us at
// 67 TFLOP/s.  So bytes bind in fp32 and the exp unit in bf16.  The
// decomposition itself costs a second exp per state and step (passes A and
// C both walk every step), so the kernel can reach at best half the exp
// bound; pass A reads u, delta and B a second time.  PERF.md has what it
// reaches on the card, pass by pass.
//
// Tensor cores do not apply: Mamba-1's decay exp(dt * A) is diagonal per
// (d, n), so the scan is an elementwise first-order recurrence, not a matrix
// product (Mamba-2's scalar-per-head decay is what makes its chunks GEMMs).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;              // d_state, held by each thread
// channels per block, one each; the wrapper reads it through
// vivim_selective_scan_fwd_threads() to size the grid
constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;       // per SM: caps registers at 128
constexpr int kSub = 8;             // steps of u / delta / z per register tile
constexpr int kTile = 32;           // steps of B / C per shared-memory tile
constexpr int kStage = kTile * kN / kThreads;  // B (and C) values a thread stages
// Steps per saved chunk-start state.  selective_scan_bwd.cu holds one
// chunk of recomputed states in registers, which is what bounds it; the
// Python wrapper passes its own value and the launch refuses a mismatch.
// `l_chunk`, the parallel chunk, is a multiple of it.
constexpr int kChunk = 16;
constexpr int kCarryThreads = 64;
constexpr int kCarryUnroll = 16;    // chunk loads in flight per carry thread
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kChunk % kSub == 0 && kTile % kSub == 0, "tiles of whole subs");
static_assert((kTile * kN) % kThreads == 0, "B / C tile splits over threads");
static_assert(kThreads % 32 == 0, "whole warps");

enum Pass { kLocal = 0, kOut = 1 };

struct Params {
  const void* u;
  const void* delta;
  const void* z;
  const void* B;
  const void* C;
  const float* A;       // (pb, D, N), batch stride A_sb (0 = shared)
  const float* Dskip;   // (pb, D), batch stride D_sb
  const float* bias;    // (pb, D), batch stride bias_sb
  const float* h0;      // (batch, D, N) or null
  void* y;              // (batch, L, D) in T, strides y_sb, y_sl
  float* last;          // (batch, D, N) contiguous
  float* cs;            // (batch, ceil(L / kChunk), D, N) or null
  float* hbuf;          // (batch, n_chunks - 1, D, N) scratch
  float* sbuf;          // (batch, n_chunks - 1, D) scratch
  int L, D, l_chunk, n_chunks;
  int64_t u_sb, u_sl, dl_sb, dl_sl, z_sb, z_sl, y_sb, y_sl;
  int64_t B_sb, B_sl, C_sb, C_sl;
  int64_t A_sb, D_sb, bias_sb, h0_sb;
  int softplus;
};

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

// 2^x on the MUFU: one instruction, relative error about 2^-22.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// softplus(x) = log1p(e^x) with no select around it (a ternary here
// compiles to a divergent branch that stops the steps from overlapping).
// log1p(e^x) > x, so the max is x only above the clamp at 20, where
// torch.nn.functional.softplus returns x too.  log1pf keeps the relative
// error small where softplus is small (dt near 1e-3 at the floor of the dt
// init): log(1 + e^x) through the fast __logf would carry an absolute error
// of about 4e-7 there, 4e-4 of dt.
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(log1pf(__expf(fminf(x, 20.f))), x);
}

// u, delta (and z) of kSub steps of one channel in registers, and running
// pointers to the step after them (a pointer bump per step, where t * stride
// would cost a 64-bit multiply).
template <typename T, bool kHasZ>
struct Series {
  float u[kSub], dl[kSub], z[kSub];
  const T* u_p;
  const T* dl_p;
  const T* z_p;

  // loads steps t0 .. t0 + kSub - 1 (zeros from t1 on, or when not live)
  __device__ __forceinline__ void load(const Params& p, int t0, int t1,
                                       bool live) {
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const bool ok = live && t0 + i < t1;
      u[i] = ok ? to_f(*u_p) : 0.f;
      dl[i] = ok ? to_f(*dl_p) : 0.f;
      if (kHasZ) z[i] = ok ? to_f(*z_p) : 0.f;
      u_p += p.u_sl;
      dl_p += p.dl_sl;
      if (kHasZ) z_p += p.z_sl;
    }
  }
};

// The block's share of one kTile x N tile of B (and C): thread `tid` loads
// entries tid, tid + kThreads, ... (row-major (t, n)), so 16 neighbouring
// threads read one contiguous row.
template <typename T, bool kWithC>
struct Stage {
  float b[kStage], c[kStage];

  __device__ __forceinline__ void load(const T* B_p, const T* C_p,
                                       const Params& p, int t0, int t1,
                                       int tid) {
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int e = tid + j * kThreads;
      const int t = t0 + e / kN;
      const bool ok = t < t1;
      b[j] = ok ? to_f(B_p[t * p.B_sl + e % kN]) : 0.f;
      if (kWithC) c[j] = ok ? to_f(C_p[t * p.C_sl + e % kN]) : 0.f;
    }
  }

  __device__ __forceinline__ void store(float (*sB)[kN], float (*sC)[kN],
                                        int tid) const {
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int e = tid + j * kThreads;
      sB[e / kN][e % kN] = b[j];
      if (kWithC) sC[e / kN][e % kN] = c[j];
    }
  }
};

__device__ __forceinline__ void store16(float* dst, const float (&h)[kN]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < kN / 4; ++q)
    d4[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
}

// Pass A (kLocal) or C (kOut) over chunk blockIdx.y of batch row blockIdx.z,
// channels blockIdx.x * kThreads + threadIdx.x.
template <typename T, int kPass, bool kHasZ, bool kSaveCS, bool kSoftplus>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
selective_scan_fwd_chunk_kernel(Params p) {
  constexpr bool kWithC = kPass == kOut;
  __shared__ __align__(16) float sB[2][kTile][kN];
  __shared__ __align__(16) float sC[kWithC ? 2 : 1][kTile][kN];

  const int tid = threadIdx.x;
  const int d = blockIdx.x * kThreads + tid;
  const int k = blockIdx.y;
  const int64_t b = blockIdx.z;
  const bool live = d < p.D;
  const int dc = live ? d : 0;  // dead channels address channel 0
  const int c0 = k * p.l_chunk;
  const int c1 = min(p.L, c0 + p.l_chunk);
  const int64_t n_carry = p.n_chunks - 1;

  float a2[kN], h[kN];
  const float* A_p = p.A + b * p.A_sb + (int64_t)dc * kN;
#pragma unroll
  for (int n = 0; n < kN; ++n) a2[n] = live ? A_p[n] * kLog2e : 0.f;
  const float bi = live ? p.bias[b * p.bias_sb + dc] : 0.f;
  const float dsk = (kWithC && live) ? p.Dskip[b * p.D_sb + dc] : 0.f;
  if (kPass == kOut && live && k > 0) {
    const float4* s4 = reinterpret_cast<const float4*>(
        p.hbuf + ((b * n_carry + k - 1) * p.D + d) * kN);
#pragma unroll
    for (int q = 0; q < kN / 4; ++q) {
      const float4 v = s4[q];
      h[4 * q] = v.x;
      h[4 * q + 1] = v.y;
      h[4 * q + 2] = v.z;
      h[4 * q + 3] = v.w;
    }
  } else if (kPass == kOut && live && p.h0 != nullptr) {  // first chunk
    const float* h0_p = p.h0 + b * p.h0_sb + (int64_t)d * kN;
#pragma unroll
    for (int n = 0; n < kN; ++n) h[n] = h0_p[n];
  } else {
#pragma unroll
    for (int n = 0; n < kN; ++n) h[n] = 0.f;
  }

  Series<T, kHasZ> cur, nxt;
  cur.u_p = static_cast<const T*>(p.u) + b * p.u_sb + c0 * p.u_sl + dc;
  cur.dl_p = static_cast<const T*>(p.delta) + b * p.dl_sb + c0 * p.dl_sl + dc;
  cur.z_p = kHasZ ? static_cast<const T*>(p.z) + b * p.z_sb + c0 * p.z_sl + dc
                  : nullptr;
  const T* B_p = static_cast<const T*>(p.B) + b * p.B_sb;
  const T* C_p = static_cast<const T*>(p.C) + b * p.C_sb;
  T* y_p = static_cast<T*>(p.y) + b * p.y_sb + c0 * p.y_sl + dc;

  const int n_tiles = (c1 - c0 + kTile - 1) / kTile;
  Stage<T, kWithC> st;
  st.load(B_p, C_p, p, c0, c1, tid);
  st.store(sB[0], sC[0], tid);
  __syncthreads();
  if (n_tiles > 1) st.load(B_p, C_p, p, c0 + kTile, c1, tid);

  cur.load(p, c0, c1, live);
  nxt.u_p = cur.u_p;
  nxt.dl_p = cur.dl_p;
  nxt.z_p = cur.z_p;
  float S = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    const int tt0 = c0 + j * kTile;
    const int tt1 = min(c1, tt0 + kTile);
    const float (*tB)[kN] = sB[buf];
    const float (*tC)[kN] = sC[kWithC ? buf : 0];
    for (int s0 = tt0; s0 < tt1; s0 += kSub) {
      // the next sub-tile's loads are in flight during this one's arithmetic
      nxt.load(p, s0 + kSub, c1, live);
      if (kSaveCS && s0 % kChunk == 0 && live)
        store16(p.cs + ((b * ((p.L + kChunk - 1) / kChunk) + s0 / kChunk) *
                            p.D + d) * kN, h);
      // No branch inside the unrolled steps, so the compiler can overlap
      // the steps' softplus with the exps: a step past the chunk's end gets
      // dt = 0, which leaves h as it is (exp(0) = 1, dt * u = 0).
      float dt[kSub], du[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const float x = cur.dl[i] + bi;
        dt[i] = s0 + i < tt1 ? (kSoftplus ? softplus(x) : x) : 0.f;
        du[i] = dt[i] * cur.u[i];
        if (kPass == kLocal) S += dt[i];
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int r = min(s0 + i - tt0, kTile - 1);
        if (kPass == kLocal) {
#pragma unroll
          for (int n = 0; n < kN; ++n)
            h[n] = fmaf(ex2(dt[i] * a2[n]), h[n], du[i] * tB[r][n]);
        } else {
          float yq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int n = 0; n < kN; ++n) {
            h[n] = fmaf(ex2(dt[i] * a2[n]), h[n], du[i] * tB[r][n]);
            yq[n & 3] = fmaf(h[n], tC[r][n], yq[n & 3]);
          }
          float out = fmaf(dsk, cur.u[i], (yq[0] + yq[1]) + (yq[2] + yq[3]));
          if (kHasZ) {
            const float zv = cur.z[i];
            out *= __fdividef(zv, 1.f + __expf(-zv));
          }
          if (live && s0 + i < tt1) *y_p = from_f<T>(out);
          y_p += p.y_sl;
        }
      }
      cur = nxt;
    }
    if (j + 1 < n_tiles) {
      st.store(sB[buf ^ 1], sC[kWithC ? buf ^ 1 : 0], tid);
      __syncthreads();
      if (j + 2 < n_tiles) st.load(B_p, C_p, p, c0 + (j + 2) * kTile, c1, tid);
    }
  }

  if (!live) return;
  if (kPass == kLocal) {
    const int64_t slot = (b * n_carry + k) * p.D + d;
    store16(p.hbuf + slot * kN, h);
    p.sbuf[slot] = S;
  } else if (k == p.n_chunks - 1) {
    store16(p.last + (b * p.D + d) * kN, h);
  }
}

// Pass B: one thread per (b, d, n) carries the state over the chunks.
__global__ void __launch_bounds__(kCarryThreads)
selective_scan_fwd_carry_kernel(Params p, int batch) {
  const int64_t i = (int64_t)blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= (int64_t)batch * p.D * kN) return;
  const int n = (int)(i % kN);
  const int64_t d = (i / kN) % p.D;
  const int64_t b = i / ((int64_t)kN * p.D);
  const int64_t n_carry = p.n_chunks - 1;
  const float a2 = p.A[b * p.A_sb + d * kN + n] * kLog2e;
  float H = p.h0 != nullptr ? p.h0[b * p.h0_sb + d * kN + n] : 0.f;
  float* h_p = p.hbuf + (b * n_carry * p.D + d) * kN + n;
  const float* s_p = p.sbuf + b * n_carry * p.D + d;
  const int64_t h_step = (int64_t)p.D * kN;
  for (int64_t k0 = 0; k0 < n_carry; k0 += kCarryUnroll) {
    float hl[kCarryUnroll], s[kCarryUnroll];
#pragma unroll
    for (int j = 0; j < kCarryUnroll; ++j) {
      const bool ok = k0 + j < n_carry;
      hl[j] = ok ? h_p[(k0 + j) * h_step] : 0.f;
      s[j] = ok ? s_p[(k0 + j) * p.D] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kCarryUnroll; ++j) {
      if (k0 + j < n_carry) {
        H = fmaf(ex2(a2 * s[j]), H, hl[j]);
        h_p[(k0 + j) * h_step] = H;
      }
    }
  }
}

template <typename T, int kPass, bool kHasZ, bool kSaveCS>
void launch_chunks(const Params& p, dim3 grid, cudaStream_t stream) {
  if (p.softplus)
    selective_scan_fwd_chunk_kernel<T, kPass, kHasZ, kSaveCS, true>
        <<<grid, kThreads, 0, stream>>>(p);
  else
    selective_scan_fwd_chunk_kernel<T, kPass, kHasZ, kSaveCS, false>
        <<<grid, kThreads, 0, stream>>>(p);
}

template <typename T>
cudaError_t launch(const Params& p, int batch, bool has_z,
                   cudaStream_t stream) {
  const unsigned tiles = (p.D + kThreads - 1) / kThreads;
  if (p.n_chunks > 1) {
    launch_chunks<T, kLocal, false, false>(
        p, dim3(tiles, p.n_chunks - 1, batch), stream);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t states = (int64_t)batch * p.D * kN;
    selective_scan_fwd_carry_kernel<<<
        (unsigned)((states + kCarryThreads - 1) / kCarryThreads),
        kCarryThreads, 0, stream>>>(p, batch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(tiles, p.n_chunks, batch);
  if (p.cs != nullptr) {
    if (has_z) return cudaErrorInvalidValue;  // training variant: no z
    launch_chunks<T, kOut, false, true>(p, grid, stream);
  } else if (has_z) {
    launch_chunks<T, kOut, true, false>(p, grid, stream);
  } else {
    launch_chunks<T, kOut, false, false>(p, grid, stream);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (u, delta, z, B, C and y share it).
// Pointers to A, Dskip and bias are fp32; h0 may be null; z may be null.
// cs (fp32 chunk-start states) selects the training variant, which takes
// no z; `chunk` must equal kChunk.  `l_chunk` (a multiple of kChunk) is the
// parallel chunk; with n_chunks = ceil(L / l_chunk) > 1, hbuf
// (batch, n_chunks - 1, D, N) and sbuf (batch, n_chunks - 1, D) are fp32
// scratch.  Returns cudaGetLastError() after the launches (0 = success).
int vivim_selective_scan_fwd(
    const void* u, const void* delta, const void* z, const void* B,
    const void* C, const void* A, const void* Dskip, const void* bias,
    const void* h0, void* y, void* last, void* cs, void* hbuf, void* sbuf,
    int chunk, int l_chunk, int batch, int L, int D,
    int64_t u_sb, int64_t u_sl, int64_t dl_sb, int64_t dl_sl, int64_t z_sb,
    int64_t z_sl, int64_t y_sb, int64_t y_sl, int64_t B_sb, int64_t B_sl,
    int64_t C_sb, int64_t C_sl, int64_t A_sb, int64_t D_sb, int64_t bias_sb,
    int64_t h0_sb, int softplus, int dtype, void* stream) {
  if (chunk != kChunk || l_chunk <= 0 || l_chunk % kChunk != 0 || L < 0 ||
      D <= 0 || batch <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t n_chunks =
      L == 0 ? 1 : ((int64_t)L + l_chunk - 1) / l_chunk;
  if (n_chunks > 65535 || (n_chunks > 1 && (hbuf == nullptr || sbuf == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.u = u;
  p.delta = delta;
  p.z = z;
  p.B = B;
  p.C = C;
  p.A = static_cast<const float*>(A);
  p.Dskip = static_cast<const float*>(Dskip);
  p.bias = static_cast<const float*>(bias);
  p.h0 = static_cast<const float*>(h0);
  p.y = y;
  p.last = static_cast<float*>(last);
  p.cs = static_cast<float*>(cs);
  p.hbuf = static_cast<float*>(hbuf);
  p.sbuf = static_cast<float*>(sbuf);
  p.L = L;
  p.D = D;
  p.l_chunk = l_chunk;
  p.n_chunks = (int)n_chunks;
  p.u_sb = u_sb;
  p.u_sl = u_sl;
  p.dl_sb = dl_sb;
  p.dl_sl = dl_sl;
  p.z_sb = z_sb;
  p.z_sl = z_sl;
  p.y_sb = y_sb;
  p.y_sl = y_sl;
  p.B_sb = B_sb;
  p.B_sl = B_sl;
  p.C_sb = C_sb;
  p.C_sl = C_sl;
  p.A_sb = A_sb;
  p.D_sb = D_sb;
  p.bias_sb = bias_sb;
  p.h0_sb = h0_sb;
  p.softplus = softplus;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_z = z != nullptr;
  if (dtype == 0) return (int)launch<float>(p, batch, has_z, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, batch, has_z, s);
  return (int)cudaErrorInvalidValue;
}

// Channels per block of the chunk kernels: the grid's first dimension is
// ceil(D / this), and the wrapper picks l_chunk from it.
int vivim_selective_scan_fwd_threads(void) { return kThreads; }

const char* vivim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
