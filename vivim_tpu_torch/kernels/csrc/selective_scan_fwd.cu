// Selective-scan (Mamba S6) forward for Hopper (sm_90a).
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
// Design (right first, not fast).  One thread owns one (b, d, n) state; the
// N = 16 states of a channel are one half warp, which reduces y with
// __shfl_xor_sync.  A block is one warp (two channels); the grid is
// (ceil(D / 2), batch).  Each thread walks L in order, keeping the state in a
// register, and loads the next tile of kTile timesteps into registers while it
// computes the current one.  Ragged D is masked (dead lanes compute on zeros
// and store nothing; they still join the shuffles); ragged L is masked per
// timestep.  Nothing is padded.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  The function must read u, delta,
// z and B, C once and write y once: (4 * D + 2 * N) * L * batch * size(T)
// bytes.  At Vivim-b3's stage 0 (batch 3 = three scan directions, L = 20480,
// D = 128, fp32) that is 133.7 MB, about 40 us.  Its arithmetic (an exp and
// three multiply-adds per state and step) is 0.75 GFLOP, about 11 us at the
// 67 TFLOP/s of fp32 outside the tensor cores.
//
// Expected weakness: the walk over L is sequential in each thread.  Stage 0
// runs only 3 * 128 * 16 = 6144 threads (192 warps on 132 SMs), each walking
// 20480 steps, so the kernel is latency-bound and far from the bytes bound.
// A chunk-parallel scan (associative scan inside L chunks plus a carry pass)
// is the cure, and is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;                  // d_state: lanes per channel
constexpr int kChannels = 32 / kN;      // channels per warp (= per block)
constexpr int kTile = 8;                // timesteps per register tile
// Steps per saved chunk-start state.  selective_scan_bwd.cu holds one
// chunk of recomputed states in registers, which is what bounds it; the
// Python wrapper passes its own value and the launch refuses a mismatch.
constexpr int kChunk = 16;
static_assert(kChunk % kTile == 0, "chunk starts must fall on tile starts");

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
  int L, D;
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

template <typename T, bool kHasZ>
struct Tile {
  float u[kTile], dl[kTile], z[kTile], b[kTile], c[kTile];

  __device__ __forceinline__ void load(const T* u_p, const T* dl_p,
                                       const T* z_p, const T* B_p,
                                       const T* C_p, const Params& p, int t0,
                                       bool live) {
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const int t = t0 + k;
      const bool in_l = t < p.L;
      const bool ok = live && in_l;
      u[k] = ok ? to_f(u_p[t * p.u_sl]) : 0.f;
      dl[k] = ok ? to_f(dl_p[t * p.dl_sl]) : 0.f;
      z[k] = (kHasZ && ok) ? to_f(z_p[t * p.z_sl]) : 0.f;
      b[k] = in_l ? to_f(B_p[t * p.B_sl]) : 0.f;
      c[k] = in_l ? to_f(C_p[t * p.C_sl]) : 0.f;
    }
  }
};

template <typename T, bool kHasZ, bool kSaveCS>
__global__ void __launch_bounds__(32)
selective_scan_fwd_kernel(Params p) {
  const int n = threadIdx.x % kN;
  const int d = blockIdx.x * kChannels + threadIdx.x / kN;
  const int64_t b = blockIdx.y;
  const bool live = d < p.D;
  const int dc = live ? d : 0;  // dead lanes address channel 0, store nothing

  const float a = live ? p.A[b * p.A_sb + (int64_t)dc * kN + n] : 0.f;
  const float dsk = live ? p.Dskip[b * p.D_sb + dc] : 0.f;
  const float bi = live ? p.bias[b * p.bias_sb + dc] : 0.f;
  float h = (p.h0 != nullptr && live)
                ? p.h0[b * p.h0_sb + (int64_t)dc * kN + n]
                : 0.f;

  const T* u_p = static_cast<const T*>(p.u) + b * p.u_sb + dc;
  const T* dl_p = static_cast<const T*>(p.delta) + b * p.dl_sb + dc;
  const T* z_p = kHasZ ? static_cast<const T*>(p.z) + b * p.z_sb + dc
                       : nullptr;
  const T* B_p = static_cast<const T*>(p.B) + b * p.B_sb + n;
  const T* C_p = static_cast<const T*>(p.C) + b * p.C_sb + n;
  T* y_p = static_cast<T*>(p.y) + b * p.y_sb + dc;

  Tile<T, kHasZ> cur, nxt;
  cur.load(u_p, dl_p, z_p, B_p, C_p, p, 0, live);
  const int64_t n_chunks = (p.L + kChunk - 1) / kChunk;
  for (int t0 = 0; t0 < p.L; t0 += kTile) {
    if (kSaveCS && t0 % kChunk == 0 && live)
      p.cs[((b * n_chunks + t0 / kChunk) * p.D + d) * kN + n] = h;
    // issue the next tile's loads before this tile's arithmetic
    nxt.load(u_p, dl_p, z_p, B_p, C_p, p, t0 + kTile, live);
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const int t = t0 + k;
      if (t < p.L) {  // uniform over the warp
        float dv = cur.dl[k] + bi;
        if (p.softplus) dv = dv > 20.f ? dv : log1pf(expf(dv));
        h = expf(dv * a) * h + dv * cur.u[k] * cur.b[k];
        float yv = h * cur.c[k];
#pragma unroll
        for (int off = kN / 2; off > 0; off >>= 1)
          yv += __shfl_xor_sync(0xffffffffu, yv, off);
        if (n == 0 && live) {
          float out = yv + dsk * cur.u[k];
          if (kHasZ) out *= cur.z[k] / (1.f + expf(-cur.z[k]));
          y_p[t * p.y_sl] = from_f<T>(out);
        }
      }
    }
    cur = nxt;
  }
  if (live) p.last[(b * p.D + d) * kN + n] = h;
}

template <typename T>
cudaError_t launch(const Params& p, int batch, bool has_z,
                   cudaStream_t stream) {
  dim3 grid((p.D + kChannels - 1) / kChannels, batch);
  dim3 block(32);
  if (p.cs != nullptr) {
    if (has_z) return cudaErrorInvalidValue;  // training variant: no z
    selective_scan_fwd_kernel<T, false, true><<<grid, block, 0, stream>>>(p);
  } else if (has_z) {
    selective_scan_fwd_kernel<T, true, false><<<grid, block, 0, stream>>>(p);
  } else {
    selective_scan_fwd_kernel<T, false, false><<<grid, block, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (u, delta, z, B, C and y share it).
// Pointers to A, Dskip and bias are fp32; h0 may be null; z may be null.
// cs (fp32 chunk-start states) selects the training variant, which takes
// no z; `chunk` must equal kChunk.  Returns cudaGetLastError() after the
// launch (0 = success).
int vivim_selective_scan_fwd(
    const void* u, const void* delta, const void* z, const void* B,
    const void* C, const void* A, const void* Dskip, const void* bias,
    const void* h0, void* y, void* last, void* cs, int chunk, int batch,
    int L, int D,
    int64_t u_sb, int64_t u_sl, int64_t dl_sb, int64_t dl_sl, int64_t z_sb,
    int64_t z_sl, int64_t y_sb, int64_t y_sl, int64_t B_sb, int64_t B_sl,
    int64_t C_sb, int64_t C_sl, int64_t A_sb, int64_t D_sb, int64_t bias_sb,
    int64_t h0_sb, int softplus, int dtype, void* stream) {
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
  p.L = L;
  p.D = D;
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
  if (chunk != kChunk) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_z = z != nullptr;
  if (dtype == 0) return (int)launch<float>(p, batch, has_z, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, batch, has_z, s);
  return (int)cudaErrorInvalidValue;
}

const char* vivim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
