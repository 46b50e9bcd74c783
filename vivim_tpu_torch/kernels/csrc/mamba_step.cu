// One decode token of a Mamba mixer, stepped in place, for Hopper (sm_90a):
// the causal conv's window and the selective state update.
//
// Replaces no TPU kernel.  The JAX package's decode step (its
// nn/streaming.py::mamba_step) is plain XLA: a functional
// concatenate-and-dot for the conv, and the fp32 recurrence of its
// kernels/refs.py::selective_state_update_ref.  In plain PyTorch that step
// was 21 small kernels a mixer, and two copies of the new states into the
// decode graph's buffers.  These two kernels step the states where they lie;
// the x_proj product sits between them, so they are two:
//
//   conv_step:  window[b, :, c] <- (window[b, 1:, c], x[b, c])
//               out[b, c] = silu(bias[c] + sum_k window[b, k, c] w[k, c])
//   ssm_step:   dt = softplus(dt[b, h] + dt_bias[h])  (threshold 20)
//               s[b, c, n] <- s[b, c, n] exp(dt A[h, n]) + (dt B[b, g, n]) x[b, c]
//               with A = -exp(A_log), in fp32
//               out[b, c] = (sum_n s[b, c, n] C[b, g, n] + D[h] x[b, c])
//                           * silu(z[b, c])
//               where h = c / head_dim and g = c / group_dim: a Mamba-1
//               mixer has one channel a head and one group (head_dim 1,
//               group_dim dim); a Mamba-2 mixer's heads of head_dim
//               channels share dt, dt_bias, A and D, and its groups of
//               group_dim channels share B and C.
//
// Every sum runs in fp32, in the plain version's order within a channel but
// for the sum over n.  The activations, the conv window and the parameters
// are fp32 or bf16 (a dtype code per tensor: the kernels read and write each
// in its own type); the ssm state is fp32.  Every tensor comes with its
// strides in elements, so the strided column views of in_proj's and x_proj's
// outputs are read where they lie; the ssm state's d_state stride is 1.
//
// Design.  Channels run along x, so that a warp's loads of a (batch, dim)
// row are contiguous; the grid is (channel tiles, batch).  At decode sizes a
// kernel's time is its launch, its drain and the latency of its dependent
// memory round trips, so each thread issues every load of the step before
// it uses any.  conv_step is one thread per (row, channel): it reads its
// channel's W - 1 newest slots, the new input and the W taps into
// registers, then writes the shifted window (no other thread touches the
// column) and the output.  ssm_step gives a channel `lanes` consecutive
// threads of one warp, each holding ceil(N / lanes) states n = lane + j *
// lanes in registers, so that a warp's state loads are contiguous and each
// thread's chain of exps is short; the lanes sum their parts of y with warp
// shuffles, and lane 0 writes the output.  Nothing is staged, and there is
// no barrier.  The wrapper picks the lanes from the shape
// (mamba_step.py::ssm_lanes): 16 (or the power of two at or above a smaller
// N) where the grid is small, as at mamba-130m's layer, where one thread per
// channel walking its 16 states took 4.4 us a call against 3.4; fewer, down
// to 2, where the grid is large, as at Jamba's (8, 8192), where 16 lanes
// took 30.7 us and 2 took 12.1.
//
// Bound on an H100 SXM (3.35 TB/s): bytes, but at decode sizes launch and
// drain set the time.  mamba-130m's layer at batch 1 (d_inner 1536, N 16,
// W 4, fp32) moves 197 KB of state (0.06 us) and 49 KB of window (0.015 us);
// Jamba's at batch 8 (d_inner 8192) 8.4 MB of state (2.5 us).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // threads of a block, both kernels
constexpr int kMaxWidth = 8;      // conv width
constexpr int kMaxLanes = 16;     // threads a channel of ssm_step
constexpr int kMaxPerLane = 16;   // states a thread of ssm_step
constexpr int kF32 = 0, kBF16 = 1;

__device__ __forceinline__ float ld(const void* p, int type, int64_t i) {
  return type == kBF16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, int type, int64_t i, float v) {
  if (type == kBF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

// A (batch, dim) operand: pointer, dtype code, batch and channel strides.
struct Vec2 {
  const void* p;
  int type;
  int64_t sb, sc;
  __device__ __forceinline__ float at(int b, int c) const {
    return ld(p, type, b * sb + c * sc);
  }
};

struct ConvArgs {
  Vec2 x, w, bias;        // w: (W, dim), sb its slot stride; bias: sb unused
  void* window;           // (batch, W, dim)
  int window_type;
  int64_t win_sb, win_sw, win_sc;
  void* out;              // (batch, dim) contiguous
  int out_type;
  int batch, dim, width;
};

__global__ void __launch_bounds__(kThreads)
conv_step_kernel(const ConvArgs a) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= a.dim) return;
  const int64_t base = b * a.win_sb + c * a.win_sc;
  // every load first, so that their latencies overlap: slots 1 .. W-1 of
  // the window, the new input, the taps, the bias
  float win[kMaxWidth], tap[kMaxWidth];
#pragma unroll
  for (int k = 0; k < kMaxWidth; ++k) {
    if (k < a.width) {
      win[k] = k + 1 < a.width
                   ? ld(a.window, a.window_type, base + (k + 1) * a.win_sw)
                   : a.x.at(b, c);
      tap[k] = a.w.at(k, c);
    }
  }
  const float bias = a.bias.p != nullptr ? a.bias.at(0, c) : 0.f;
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxWidth; ++k) {
    if (k < a.width) {
      st(a.window, a.window_type, base + k * a.win_sw, win[k]);
      sum += win[k] * tap[k];
    }
  }
  st(a.out, a.out_type, (int64_t)b * a.dim + c, silu(sum + bias));
}

struct SsmArgs {
  float* state;           // (batch, dim, N), unit N stride
  int64_t s_sb, s_sc;
  Vec2 x, z;              // (batch, dim)
  Vec2 dt;                // (batch, heads)
  Vec2 B, C;              // (batch, groups * N), sc their N stride
  Vec2 A_log;             // (heads, N): sb the head stride, sc N's
  Vec2 D, dt_bias;        // (heads,): sc the stride, sb unused
  void* out;              // (batch, dim) contiguous
  int out_type;
  int batch, dim, dstate;
  int head_dim;           // channels a head (dt, dt_bias, A_log, D)
  int group_dim;          // channels a group (B, C)
  int lanes;              // threads a channel: a power of two, 1 to 16
  int per_lane;           // states a thread: ceil(N / lanes), 1 to 16
};

__global__ void __launch_bounds__(kThreads)
ssm_step_kernel(const SsmArgs a) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & (a.lanes - 1);
  const int c = blockIdx.x * (kThreads / a.lanes) + threadIdx.x / a.lanes;
  const bool live = c < a.dim;
  const int h = c / a.head_dim;
  const int bc = c / a.group_dim * a.dstate;   // the group's first B, C
  float* s = a.state + b * a.s_sb + c * a.s_sc;
  // every load first, so that their latencies overlap: the channel's dt,
  // x, D and z (the same for its lanes), then the lane's states n = lane +
  // j * lanes with their A_log, B and C entries (contiguous over a warp's
  // lanes)
  float dt = 0.f, x = 0.f, D = 0.f, z = 0.f;
  float v[kMaxPerLane], A[kMaxPerLane], Bn[kMaxPerLane], Cn[kMaxPerLane];
  if (live) {
    dt = a.dt.at(b, h) + a.dt_bias.at(0, h);
    x = a.x.at(b, c);
    D = a.D.at(0, h);
    z = a.z.at(b, c);
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int n = lane + j * a.lanes;
      if (j < a.per_lane && n < a.dstate) {
        v[j] = s[n];
        A[j] = a.A_log.at(h, n);
        Bn[j] = a.B.at(b, bc + n);
        Cn[j] = a.C.at(b, bc + n);
      }
    }
  }
  dt = dt > 20.f ? dt : log1pf(expf(dt));
  float y = 0.f;
  if (live) {
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int n = lane + j * a.lanes;
      if (j < a.per_lane && n < a.dstate) {
        v[j] = v[j] * expf(dt * -expf(A[j])) + (dt * Bn[j]) * x;
        y += v[j] * Cn[j];
        s[n] = v[j];
      }
    }
  }
  // the channel's sum over n: its lanes are consecutive lanes of one warp,
  // and every lane of the warp takes part
  for (int o = a.lanes / 2; o > 0; o >>= 1)
    y += __shfl_xor_sync(0xffffffffu, y, o);
  if (live && lane == 0)
    st(a.out, a.out_type, (int64_t)b * a.dim + c, (y + D * x) * silu(z));
}

bool type_ok(int t) { return t == kF32 || t == kBF16; }

Vec2 vec2(const void* p, int type, int64_t sb, int64_t sc) {
  Vec2 v;
  v.p = p;
  v.type = type;
  v.sb = sb;
  v.sc = sc;
  return v;
}


}  // namespace

extern "C" {

// conv_step.  ptrs: x, window, weight, bias (may be null), out; types: their
// dtype codes (0 fp32, 1 bf16), in that order; strides: x (batch, channel),
// window (batch, slot, channel), weight (slot, channel), bias (channel).
// out is (batch, dim) contiguous.  batch 1 to 65535, width 1 to 8.  Returns
// cudaGetLastError() after the launch (0 = success).
int vivim_conv_step(void* const* ptrs, const int* types,
                    const int64_t* strides, int batch, int dim, int width,
                    void* stream) {
  for (int i = 0; i < 5; ++i)
    if (!type_ok(types[i])) return (int)cudaErrorInvalidValue;
  if (batch < 1 || batch > 65535 || dim < 1 || width < 1 ||
      width > kMaxWidth)
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.x = vec2(ptrs[0], types[0], strides[0], strides[1]);
  a.window = ptrs[1];
  a.window_type = types[1];
  a.win_sb = strides[2];
  a.win_sw = strides[3];
  a.win_sc = strides[4];
  a.w = vec2(ptrs[2], types[2], strides[5], strides[6]);
  a.bias = vec2(ptrs[3], types[3], 0, strides[7]);
  a.out = ptrs[4];
  a.out_type = types[4];
  a.batch = batch;
  a.dim = dim;
  a.width = width;
  const dim3 grid((unsigned)((dim + kThreads - 1) / kThreads),
                  (unsigned)batch);
  conv_step_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}

// ssm_step.  ptrs: state (fp32), x, dt, z, B, C, A_log, D, dt_bias, out;
// types: the dtype codes of all but the state, in that order; strides:
// state (batch, channel; its N stride is 1), x, z (batch, channel each), dt
// (batch, head), B, C (batch, group * n + n each), A_log (head, n), D,
// dt_bias (head each).  out is (batch, dim) contiguous.  lanes a power of two
// up to 16, per_lane 1 to 16 states a lane, lanes * per_lane >= dstate (so
// dstate <= 256); head_dim and group_dim divide dim (1 and dim: a Mamba-1
// mixer).  Returns cudaGetLastError() after the launch (0 = success).
int vivim_ssm_step(void* const* ptrs, const int* types,
                   const int64_t* strides, int batch, int dim, int dstate,
                   int lanes, int per_lane, int head_dim, int group_dim,
                   void* stream) {
  for (int i = 0; i < 9; ++i)
    if (!type_ok(types[i])) return (int)cudaErrorInvalidValue;
  if (batch < 1 || batch > 65535 || dim < 1 || dstate < 1 ||
      lanes < 1 || lanes > kMaxLanes || (lanes & (lanes - 1)) != 0 ||
      per_lane < 1 || per_lane > kMaxPerLane || lanes * per_lane < dstate ||
      head_dim < 1 || group_dim < 1 || dim % head_dim != 0 ||
      dim % group_dim != 0)
    return (int)cudaErrorInvalidValue;
  SsmArgs a;
  a.state = static_cast<float*>(ptrs[0]);
  a.s_sb = strides[0];
  a.s_sc = strides[1];
  a.x = vec2(ptrs[1], types[0], strides[2], strides[3]);
  a.dt = vec2(ptrs[2], types[1], strides[4], strides[5]);
  a.z = vec2(ptrs[3], types[2], strides[6], strides[7]);
  a.B = vec2(ptrs[4], types[3], strides[8], strides[9]);
  a.C = vec2(ptrs[5], types[4], strides[10], strides[11]);
  a.A_log = vec2(ptrs[6], types[5], strides[12], strides[13]);
  a.D = vec2(ptrs[7], types[6], 0, strides[14]);
  a.dt_bias = vec2(ptrs[8], types[7], 0, strides[15]);
  a.out = ptrs[9];
  a.out_type = types[8];
  a.batch = batch;
  a.dim = dim;
  a.dstate = dstate;
  a.lanes = lanes;
  a.per_lane = per_lane;
  a.head_dim = head_dim;
  a.group_dim = group_dim;
  const int channels = kThreads / lanes;
  const dim3 grid((unsigned)((dim + channels - 1) / channels),
                  (unsigned)batch);
  ssm_step_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}

const char* vivim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
