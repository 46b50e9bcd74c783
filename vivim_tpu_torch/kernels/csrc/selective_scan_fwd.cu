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
// The state dimension N is any value from 1 to kMaxN = 256 (the Pallas
// kernel takes any N; mamba_ssm's CUDA scan checks dstate <= 256).
//
// Design.  A channel d is owned by kG threads of one warp (its "lanes"),
// each holding kNS states and their A * log2(e) in registers, so a channel
// holds kNp = kNS * kG >= N states, the ones at or past N masked (B and C
// read as 0, A as 0: such a state stays 0 and adds nothing to y).  The
// family (kNS, kG) is picked from N: one lane of kNS = 1, 2, 4, 8 or 16
// states for N <= 16 (N = 16 is kNS = 16, kG = 1); for 16 < N <= 256,
// kG = 2, 4, 8 or 16 lanes of 16 states each, lane g holding states
// g, g + kG, g + 2 kG, ... so that the kG lanes read kG neighbouring
// shared-memory words (no bank conflict).  y = sum_n C_n h_n is summed in
// each lane's registers, then over the kG lanes with log2(kG) xor
// shuffles; lane 0 gates and stores.  The layout is time-major
// (batch, L, D) with D contiguous, so a warp's channels read u, delta and
// z and write y coalesced.  Per step a lane computes
// dt = softplus(delta + bias) once and each state's decay as one ex2
// (MUFU) of dt * A * log2(e).  B and C, shared by every channel, are staged
// per kTile steps in shared memory (double-buffered, coalesced loads from
// their strided rows; kTile shrinks as N grows so that the tiles stay in
// 48 KB of static shared memory) and read as broadcasts.  u, delta and z
// are prefetched kSub steps ahead in registers.
//
// L is split into chunks of `l_chunk` steps (a multiple of kChunk chosen by
// the wrapper per shape so that the grid has a few blocks per SM); the grid
// is (ceil(D / channels per block) channel tiles, chunks, batch).  Three
// passes:
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
// chunk; ragged N masks states; nothing is padded.  The wrapper allocates
// the scratch, whose (b, ., d, n) rows hold N floats.
//
// Bounds on an H100 SXM (3.35 TB/s HBM3; 16 MUFU ops per clock per SM x 132
// SMs x 1.98 GHz = 4.2 T ex2/s).  Bytes: the function must read u, delta, z,
// B and C once and write y once, (4 * D + 2 * N) * L * batch * size(T):
// 133.7 MB, 40 us, at Vivim-b3's serving stage 0 (batch 3 = three scan
// directions, L = 20480, D = 128, fp32, N = 16).  Exps: one per state and
// step, batch * L * D * N = 126 M there, 30 us.  fp32 arithmetic (about six
// operations per state and step outside the exp) is 0.75 GFLOP, 11 us at
// 67 TFLOP/s.  So bytes bind in fp32 and the exp unit in bf16; the exps
// grow with N and bind from about N = 32 on at the LM's shapes.  The
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

constexpr int kMaxN = 256;          // the largest d_state
constexpr int kThreads = 128;       // threads per block
constexpr int kSub = 8;             // steps of u / delta / z per register tile
// Steps per saved chunk-start state.  selective_scan_bwd.cu holds one
// chunk of recomputed states in registers, which is what bounds it; the
// Python wrapper passes its own value and the launch refuses a mismatch.
// `l_chunk`, the parallel chunk, is a multiple of it.
constexpr int kChunk = 16;
constexpr int kCarryThreads = 64;
constexpr int kCarryUnroll = 16;    // chunk loads in flight per carry thread
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kChunk % kSub == 0, "chunks of whole subs");
static_assert(kThreads % 32 == 0, "whole warps");

// kNS_ states in each of kG_ lanes per channel; kExactN_ > 0 fixes N at
// compile time (N = 16, whose masks and index arithmetic then fold away),
// 0 reads it from the launch.
template <int kNS_, int kG_, int kExactN_ = 0>
struct Family {
  static constexpr int kNS = kNS_;
  static constexpr int kG = kG_;
  static constexpr int kExactN = kExactN_;
  static constexpr int kNp = kNS * kG;         // states held per channel
  static constexpr int kCh = kThreads / kG;    // channels per block
  // steps of B / C per shared-memory tile: 2 buffers x 2 (B, C) x kTile x
  // kNp floats stay within 32 KB
  static constexpr int kTile = kNp <= 16 ? 32 : (kNp <= 32 ? 16 : 8);
  // B (and C) values a thread stages per tile
  static constexpr int kStage = (kTile * kNp + kThreads - 1) / kThreads;
  // blocks per SM: 4 caps registers at 128; the widest families stage up
  // to 2 x 16 values per thread and get 255
  static constexpr int kMinBlocks = kNp <= 64 ? 4 : 2;
  static_assert(kTile % kSub == 0, "tiles of whole subs");
  static_assert(kG <= 32 && 32 % kG == 0, "a channel's lanes in one warp");
  static_assert(kExactN == 0 || kExactN == kNp, "an exact N fills the lanes");
  // N: the compile-time one, or the launch's
  static __device__ __forceinline__ int n(int N) {
    return kExactN ? kExactN : N;
  }
};

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
  int L, D, N, l_chunk, n_chunks;
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

// A lane's states in a (b, ., d) row of N fp32 values: state n * kG + g of
// the row is h[n]; states at or past N read as 0 and are not written.  One
// lane holding a whole row of a multiple of 4 (N = 4, 8, 16) moves float4s.
template <class F>
__device__ __forceinline__ bool whole_row(int N) {
  return F::kG == 1 && F::kNS % 4 == 0 && N == F::kNS;
}

template <class F>
__device__ __forceinline__ void load_states(const float* row, int N, int g,
                                            float (&h)[F::kNS]) {
  if (whole_row<F>(N)) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int q = 0; q < F::kNS / 4; ++q) {
      const float4 v = r4[q];
      h[4 * q] = v.x;
      h[4 * q + 1] = v.y;
      h[4 * q + 2] = v.z;
      h[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int n = 0; n < F::kNS; ++n)
      h[n] = n * F::kG + g < N ? row[n * F::kG + g] : 0.f;
  }
}

template <class F>
__device__ __forceinline__ void store_states(float* row, int N, int g,
                                             const float (&h)[F::kNS]) {
  if (whole_row<F>(N)) {
    float4* r4 = reinterpret_cast<float4*>(row);
#pragma unroll
    for (int q = 0; q < F::kNS / 4; ++q)
      r4[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  } else {
#pragma unroll
    for (int n = 0; n < F::kNS; ++n)
      if (n * F::kG + g < N) row[n * F::kG + g] = h[n];
  }
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

// The block's share of one kTile x kNp tile of B (and C): thread `tid`
// loads entries tid, tid + kThreads, ... (row-major (t, n)), so
// neighbouring threads read one contiguous row; columns at or past N read
// as 0.
template <typename T, class F, bool kWithC>
struct Stage {
  static constexpr int kCount = F::kTile * F::kNp;
  float b[F::kStage], c[F::kStage];

  __device__ __forceinline__ void load(const T* B_p, const T* C_p,
                                       const Params& p, int t0, int t1,
                                       int tid) {
#pragma unroll
    for (int j = 0; j < F::kStage; ++j) {
      const int e = tid + j * kThreads;
      const int t = t0 + e / F::kNp, col = e % F::kNp;
      const bool ok = (kCount % kThreads == 0 || e < kCount) && t < t1 &&
                      col < F::n(p.N);
      b[j] = ok ? to_f(B_p[t * p.B_sl + col]) : 0.f;
      if (kWithC) c[j] = ok ? to_f(C_p[t * p.C_sl + col]) : 0.f;
    }
  }

  __device__ __forceinline__ void store(float (*sB)[F::kNp],
                                        float (*sC)[F::kNp], int tid) const {
#pragma unroll
    for (int j = 0; j < F::kStage; ++j) {
      const int e = tid + j * kThreads;
      if (kCount % kThreads != 0 && e >= kCount) continue;
      sB[e / F::kNp][e % F::kNp] = b[j];
      if (kWithC) sC[e / F::kNp][e % F::kNp] = c[j];
    }
  }
};

// Pass A (kLocal) or C (kOut) over chunk blockIdx.y of batch row blockIdx.z,
// channels blockIdx.x * kCh + threadIdx.x / kG.
template <typename T, class F, int kPass, bool kHasZ, bool kSaveCS,
          bool kSoftplus>
__global__ void __launch_bounds__(kThreads, F::kMinBlocks)
selective_scan_fwd_chunk_kernel(Params p) {
  constexpr int kNS = F::kNS, kG = F::kG, kTile = F::kTile;
  constexpr bool kWithC = kPass == kOut;
  __shared__ __align__(16) float sB[2][kTile][F::kNp];
  __shared__ __align__(16) float sC[kWithC ? 2 : 1][kTile][F::kNp];

  const int tid = threadIdx.x;
  const int g = tid % kG;  // this lane holds states g, g + kG, ...
  const int d = blockIdx.x * F::kCh + tid / kG;
  const int k = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int N = F::n(p.N);
  const bool live = d < p.D;
  const int dc = live ? d : 0;  // dead channels address channel 0
  const int c0 = k * p.l_chunk;
  const int c1 = min(p.L, c0 + p.l_chunk);
  const int64_t n_carry = p.n_chunks - 1;

  float a2[kNS], h[kNS];
  const float* A_p = p.A + b * p.A_sb + (int64_t)dc * N;
#pragma unroll
  for (int n = 0; n < kNS; ++n)
    a2[n] = live && n * kG + g < N ? A_p[n * kG + g] * kLog2e : 0.f;
  const float bi = live ? p.bias[b * p.bias_sb + dc] : 0.f;
  const float dsk = (kWithC && live) ? p.Dskip[b * p.D_sb + dc] : 0.f;
  if (kPass == kOut && live && k > 0) {
    load_states<F>(p.hbuf + ((b * n_carry + k - 1) * p.D + d) * N, N, g, h);
  } else if (kPass == kOut && live && p.h0 != nullptr) {  // first chunk
    load_states<F>(p.h0 + b * p.h0_sb + (int64_t)d * N, N, g, h);
  } else {
#pragma unroll
    for (int n = 0; n < kNS; ++n) h[n] = 0.f;
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
  Stage<T, F, kWithC> st;
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
    const float (*tB)[F::kNp] = sB[buf];
    const float (*tC)[F::kNp] = sC[kWithC ? buf : 0];
    for (int s0 = tt0; s0 < tt1; s0 += kSub) {
      // the next sub-tile's loads are in flight during this one's arithmetic
      nxt.load(p, s0 + kSub, c1, live);
      if (kSaveCS && s0 % kChunk == 0 && live)
        store_states<F>(p.cs + ((b * ((p.L + kChunk - 1) / kChunk) +
                                 s0 / kChunk) * p.D + d) * N, N, g, h);
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
          for (int n = 0; n < kNS; ++n)
            h[n] = fmaf(ex2(dt[i] * a2[n]), h[n], du[i] * tB[r][n * kG + g]);
        } else {
          float yq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int n = 0; n < kNS; ++n) {
            h[n] = fmaf(ex2(dt[i] * a2[n]), h[n], du[i] * tB[r][n * kG + g]);
            yq[n & 3] = fmaf(h[n], tC[r][n * kG + g], yq[n & 3]);
          }
          float y = (yq[0] + yq[1]) + (yq[2] + yq[3]);
#pragma unroll
          for (int off = 1; off < kG; off <<= 1)  // the channel's lanes
            y += __shfl_xor_sync(0xffffffffu, y, off);
          float out = fmaf(dsk, cur.u[i], y);
          if (kHasZ) {
            const float zv = cur.z[i];
            out *= __fdividef(zv, 1.f + __expf(-zv));
          }
          if (live && g == 0 && s0 + i < tt1) *y_p = from_f<T>(out);
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
    store_states<F>(p.hbuf + slot * N, N, g, h);
    if (g == 0) p.sbuf[slot] = S;
  } else if (k == p.n_chunks - 1) {
    store_states<F>(p.last + (b * p.D + d) * N, N, g, h);
  }
}

// Pass B: one thread per (b, d, n) carries the state over the chunks.
template <class F>
__global__ void __launch_bounds__(kCarryThreads)
selective_scan_fwd_carry_kernel(Params p, int batch) {
  const int64_t i = (int64_t)blockIdx.x * kCarryThreads + threadIdx.x;
  const int N = F::n(p.N);
  if (i >= (int64_t)batch * p.D * N) return;
  const int n = (int)(i % N);
  const int64_t d = (i / N) % p.D;
  const int64_t b = i / ((int64_t)N * p.D);
  const int64_t n_carry = p.n_chunks - 1;
  const float a2 = p.A[b * p.A_sb + d * N + n] * kLog2e;
  float H = p.h0 != nullptr ? p.h0[b * p.h0_sb + d * N + n] : 0.f;
  float* h_p = p.hbuf + (b * n_carry * p.D + d) * N + n;
  const float* s_p = p.sbuf + b * n_carry * p.D + d;
  const int64_t h_step = (int64_t)p.D * N;
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

// Calls fn(Family<kNS, kG>()) for the family that holds N states.
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

template <typename T, class F, int kPass, bool kHasZ, bool kSaveCS>
void launch_chunks(const Params& p, dim3 grid, cudaStream_t stream) {
  if (p.softplus)
    selective_scan_fwd_chunk_kernel<T, F, kPass, kHasZ, kSaveCS, true>
        <<<grid, kThreads, 0, stream>>>(p);
  else
    selective_scan_fwd_chunk_kernel<T, F, kPass, kHasZ, kSaveCS, false>
        <<<grid, kThreads, 0, stream>>>(p);
}

template <typename T, class F>
cudaError_t launch(const Params& p, int batch, bool has_z,
                   cudaStream_t stream) {
  const unsigned tiles = (p.D + F::kCh - 1) / F::kCh;
  if (p.n_chunks > 1) {
    launch_chunks<T, F, kLocal, false, false>(
        p, dim3(tiles, p.n_chunks - 1, batch), stream);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t states = (int64_t)batch * p.D * p.N;
    selective_scan_fwd_carry_kernel<F><<<
        (unsigned)((states + kCarryThreads - 1) / kCarryThreads),
        kCarryThreads, 0, stream>>>(p, batch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(tiles, p.n_chunks, batch);
  if (p.cs != nullptr) {
    if (has_z) return cudaErrorInvalidValue;  // training variant: no z
    launch_chunks<T, F, kOut, false, true>(p, grid, stream);
  } else if (has_z) {
    launch_chunks<T, F, kOut, true, false>(p, grid, stream);
  } else {
    launch_chunks<T, F, kOut, false, false>(p, grid, stream);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (u, delta, z, B, C and y share it).
// Pointers to A, Dskip and bias are fp32; h0 may be null; z may be null.
// N, the state dimension, is 1 to 256.  cs (fp32 chunk-start states)
// selects the training variant, which takes no z; `chunk` must equal
// kChunk.  `l_chunk` (a multiple of kChunk) is the parallel chunk; with
// n_chunks = ceil(L / l_chunk) > 1, hbuf (batch, n_chunks - 1, D, N) and
// sbuf (batch, n_chunks - 1, D) are fp32 scratch.  Returns
// cudaGetLastError() after the launches (0 = success).
int vivim_selective_scan_fwd(
    const void* u, const void* delta, const void* z, const void* B,
    const void* C, const void* A, const void* Dskip, const void* bias,
    const void* h0, void* y, void* last, void* cs, void* hbuf, void* sbuf,
    int chunk, int l_chunk, int batch, int L, int D, int N,
    int64_t u_sb, int64_t u_sl, int64_t dl_sb, int64_t dl_sl, int64_t z_sb,
    int64_t z_sl, int64_t y_sb, int64_t y_sl, int64_t B_sb, int64_t B_sl,
    int64_t C_sb, int64_t C_sl, int64_t A_sb, int64_t D_sb, int64_t bias_sb,
    int64_t h0_sb, int softplus, int dtype, void* stream) {
  if (chunk != kChunk || l_chunk <= 0 || l_chunk % kChunk != 0 || L < 0 ||
      D <= 0 || N < 1 || N > kMaxN || batch <= 0 || batch > 65535)
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
  p.N = N;
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
  return with_family(N, [&](auto f) {
    using F = decltype(f);
    if (dtype == 0) return (int)launch<float, F>(p, batch, has_z, s);
    if (dtype == 1) return (int)launch<__nv_bfloat16, F>(p, batch, has_z, s);
    return (int)cudaErrorInvalidValue;
  });
}

// Channels per block of the chunk kernels at state dimension N (1 to 256;
// 0 outside it): the grid's first dimension is ceil(D / this), and the
// wrapper picks l_chunk from it.
int vivim_selective_scan_fwd_channels(int N) {
  if (N < 1 || N > kMaxN) return 0;
  return with_family(N, [](auto f) { return decltype(f)::kCh; });
}

const char* vivim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
