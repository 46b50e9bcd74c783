// 3-D depthwise convolution (3x3x3 taps, stride 1, zero padding 1, one
// filter per channel) on channels-last tokens, for Hopper (sm_90a): the
// forward and its backward, in fp32.
//
// Replaces no TPU kernel.  The JAX package runs this conv (the Mix-FFN conv
// of every Vivim MambaLayer, its nn/layers.py::DWConv3d) as XLA's unrolled
// shift-multiply taps (`unrolled_depthwise_conv`: 27 channels-last taps
// summed in fp32).  Through cuDNN's grouped conv the port ran it as one
// small kernel per channel group behind NDHWC <-> NCDHW layout transforms.
// These kernels read the tokens as the Mix-FFN's fc1 leaves them, (batch,
// T*H*W, C) with unit channel stride, write their outputs in that layout, and
// read the weight and bias in nn.Conv3d's layout, (C, 1, 3, 3, 3) and (C,):
//
//   y[b,t,h,w,c]  = bias[c] + sum_{i,j,k} K[c,i,j,k] x[b,t+i-1,h+j-1,w+k-1,c]
//   dx[b,t,h,w,c] = sum_{i,j,k} K[c,2-i,2-j,2-k] dy[b,t+i-1,h+j-1,w+k-1,c]
//   dK[c,i,j,k]   = sum_{b,t,h,w} dy[b,t,h,w,c] x[b,t+i-1,h+j-1,w+k-1,c]
//   dbias[c]      = sum_{b,t,h,w} dy[b,t,h,w,c]
//
// with x (and dy) read as 0 outside the frame.  Everything is fp32: the
// wrapper casts other dtypes up before the call.
//
// Design.  A thread owns V channels (V = 4, one float4, where the channels
// and the strides allow it; else V = 1) and an item: the W outputs of one
// (b, t, h) row.  It holds its channels' 27 taps (and bias) in registers and
// walks the input columns -1 .. W left to right, loading each column's 9
// (t, h) neighbours once and adding them into three rolling accumulators,
// those of the outputs w+1, w and w-1 (taps k = 0, 1 and 2); the output w-1
// is then complete and is stored.  Each output's
// sum starts from the bias and runs over k, then over (i, j), in that fixed
// order, by fp32 FMA.  The 9 rows a column reads are the rows of its
// neighbours' items too: neighbouring items of a block (and of the blocks
// launched next) read them at about the same time, so L1 and L2 serve those
// repeats and device memory sees each input element about once.  Whole rows
// beat shorter runs at every Vivim shape measured on the H100 (the halo
// columns of a run cost more than the parallelism they add).  A block is
// (lanes, 256 / lanes) threads: x walks the channels (a power of two up to 32
// lanes, so that a warp's loads are contiguous), y the items; the grid is
// (channel tiles, rows) and a block walks the items of its row in steps of
// `rows` item groups: its block rows (and so the edges of its tiles) fall
// anywhere in a frame.  There is no shared memory and no layout pass.
//
// The backward is one fused kernel and one summing kernel.  The fused kernel
// (V = 1) walks an item as the forward does, reading dy's column w for dx
// (the same stencil with the taps mirrored, no bias) and x's column w-1 for
// dK: with the item's own dy at the columns w, w-1 and w-2 in registers,
// x's column w-1 adds into the taps k = 0, 1 and 2.  A thread sums its
// items' dK and dbias in 28 registers, then the block sums
// its threads over y in a fixed order through shared memory and writes one
// partial per (block row, tap, channel): a (rows, 28, C) buffer.  The
// summing kernel adds the rows in row order.  Nothing uses atomics, so dK
// and dbias are the same bits on every run of a shape on one card.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): bytes.  The forward
// reads x and writes y, 8 bytes per element, against 54 flops; the backward
// reads x and dy and writes dx, 12 bytes per element, against 109 flops.  A
// Vivim-b3 training step's 8 forwards move 0.49 GB (0.146 ms), its 8
// backwards 0.73 GB (0.218 ms).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // threads of a block, every kernel
constexpr int kTaps = 27;
constexpr int kPart = kTaps + 1;  // a partial row: 27 dK taps, then dbias
constexpr int kMaxLanes = 32;
constexpr int kMaxRows = 65535;   // grid y

struct Params {
  int T, H, W, C;
  int64_t items;          // batch * T * H rows
  int64_t x_sb, x_sn;     // x's batch and token strides, in elements
  int64_t dy_sb, dy_sn;   // dy's (backward)
};

struct Item {
  int b, t, h;            // the row (b, t, h)
};

__device__ __forceinline__ Item decode(int64_t item, const Params& p) {
  Item it;
  it.h = (int)(item % p.H);
  item /= p.H;
  it.t = (int)(item % p.T);
  it.b = (int)(item / p.T);
  return it;
}

template <int V>
__device__ __forceinline__ void load_vec(const float* src, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(src);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* dst, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    dst[0] = v[0];
  }
}

// The 9 (t, h) neighbours of column w of an item's row, V channels at `base`
// (the batch row's first token, at the thread's channel), 0 outside the
// frame; neighbour r = 3 i + j is (t + i - 1, h + j - 1).
template <int V>
__device__ __forceinline__ void load_column(const float* base, int64_t sn,
                                            const Item& it, const Params& p,
                                            int w, float (&col)[9][V]) {
  const bool w_in = w >= 0 && w < p.W;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int t = it.t + i - 1;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int h = it.h + j - 1;
      if (w_in && t >= 0 && t < p.T && h >= 0 && h < p.H) {
        load_vec<V>(base + (((int64_t)t * p.H + h) * p.W + w) * sn,
                    col[3 * i + j]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) col[3 * i + j][v] = 0.f;
      }
    }
  }
}

// Adds a column's 9 neighbours into the accumulators of the outputs w - 1
// (taps k = 2), w (k = 1) and w + 1 (k = 0).
template <int V>
__device__ __forceinline__ void add_column(const float (&tap)[kTaps][V],
                                           const float (&col)[9][V],
                                           float (&prev)[V], float (&cur)[V],
                                           float (&next)[V]) {
#pragma unroll
  for (int r = 0; r < 9; ++r) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      prev[v] = fmaf(tap[3 * r + 2][v], col[r][v], prev[v]);
      cur[v] = fmaf(tap[3 * r + 1][v], col[r][v], cur[v]);
      next[v] = fmaf(tap[3 * r][v], col[r][v], next[v]);
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    dwconv3d_fwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ weight,
                        const float* __restrict__ bias, float* __restrict__ y,
                        Params p) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (c >= p.C) return;
  float tap[kTaps][V], b0[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
      tap[k][v] = __ldg(weight + (int64_t)(c + v) * kTaps + k);
    b0[v] = bias ? __ldg(bias + c + v) : 0.f;
  }
  const int64_t step = (int64_t)gridDim.y * blockDim.y;
  for (int64_t item = (int64_t)blockIdx.y * blockDim.y + threadIdx.y;
       item < p.items; item += step) {
    const Item it = decode(item, p);
    const float* xb = x + it.b * p.x_sb + c;
    float* yrow = y + (((int64_t)it.b * p.T + it.t) * p.H + it.h) * p.W *
                          (int64_t)p.C + c;
    // outputs w - 1, w and w + 1 of the column w being added
    float prev[V], cur[V], next[V];
#pragma unroll
    for (int v = 0; v < V; ++v) prev[v] = cur[v] = 0.f, next[v] = b0[v];
#pragma unroll 1
    for (int s = 0; s <= p.W + 1; ++s) {
      const int w = s - 1;
      float col[9][V];
      load_column<V>(xb, p.x_sn, it, p, w, col);
      add_column<V>(tap, col, prev, cur, next);
      if (s >= 2) store_vec<V>(yrow + (int64_t)(w - 1) * p.C, prev);
#pragma unroll
      for (int v = 0; v < V; ++v) prev[v] = cur[v], cur[v] = next[v],
                                  next[v] = b0[v];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    dwconv3d_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ dy,
                        const float* __restrict__ weight,
                        float* __restrict__ dx, float* __restrict__ part,
                        Params p) {
  __shared__ float red[kPart * kThreads];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  float tap[kTaps][1], gk[kTaps], gbias = 0.f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) gk[k] = 0.f;
  if (c < p.C) {
    // mirrored taps: tap (i, j, k) is K[c, 2 - i, 2 - j, 2 - k]
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
      tap[k][0] = __ldg(weight + (int64_t)c * kTaps + (kTaps - 1 - k));
    const int64_t step = (int64_t)gridDim.y * blockDim.y;
    for (int64_t item = (int64_t)blockIdx.y * blockDim.y + threadIdx.y;
         item < p.items; item += step) {
      const Item it = decode(item, p);
      const float* xb = x + it.b * p.x_sb + c;
      const float* dyb = dy + it.b * p.dy_sb + c;
      float* dxrow = dx + (((int64_t)it.b * p.T + it.t) * p.H + it.h) * p.W *
                              (int64_t)p.C + c;
      float prev[1] = {0.f}, cur[1] = {0.f}, next[1] = {0.f};
      // the item's own dy at the dy columns w - 1 and w - 2: with the one
      // at w, the factors of x's column w - 1
      float own1 = 0.f, own2 = 0.f;
#pragma unroll 1
      for (int s = 0; s <= p.W + 2; ++s) {
        const int w = s - 1;  // dy's column; x's is w - 1
        float own = 0.f;
        if (s <= p.W + 1) {
          float col[9][1];
          load_column<1>(dyb, p.dy_sn, it, p, w, col);
          add_column<1>(tap, col, prev, cur, next);
          if (s >= 2) dxrow[(int64_t)(w - 1) * p.C] = prev[0];
          prev[0] = cur[0], cur[0] = next[0], next[0] = 0.f;
          own = col[4][0];
          gbias += own;
        }
        if (s >= 1) {
          float col[9][1];
          load_column<1>(xb, p.x_sn, it, p, w - 1, col);
#pragma unroll
          for (int r = 0; r < 9; ++r) {
            gk[3 * r] = fmaf(own, col[r][0], gk[3 * r]);
            gk[3 * r + 1] = fmaf(own1, col[r][0], gk[3 * r + 1]);
            gk[3 * r + 2] = fmaf(own2, col[r][0], gk[3 * r + 2]);
          }
        }
        own2 = own1;
        own1 = own;
      }
    }
  }
  // the block's sum over its items (threads along y), in y order
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) red[k * kThreads + tid] = gk[k];
  red[kTaps * kThreads + tid] = gbias;
  __syncthreads();
  for (int o = tid; o < kPart * (int)blockDim.x; o += kThreads) {
    const int k = o / blockDim.x, lane = o % blockDim.x;
    const int cc = blockIdx.x * blockDim.x + lane;
    float sum = 0.f;
    for (int ty = 0; ty < (int)blockDim.y; ++ty)
      sum += red[k * kThreads + ty * blockDim.x + lane];
    if (cc < p.C) part[((int64_t)blockIdx.y * kPart + k) * p.C + cc] = sum;
  }
}

// dK (C, 27) and dbias (C,): the block rows' partials summed in row order.
__global__ void __launch_bounds__(kThreads)
    dwconv3d_bwd_sum_kernel(const float* __restrict__ part,
                            float* __restrict__ dweight,
                            float* __restrict__ dbias, int rows, int C) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)kPart * C) return;
  const int k = (int)(i / C), c = (int)(i % C);
  float sum = 0.f;
  for (int r = 0; r < rows; ++r) sum += part[((int64_t)r * kPart + k) * C + c];
  if (k < kTaps)
    dweight[(int64_t)c * kTaps + k] = sum;
  else if (dbias)
    dbias[c] = sum;
}

bool shape_ok(int batch, int T, int H, int W, int C, int lanes, int rows) {
  return batch > 0 && T > 0 && H > 0 && W > 0 && C > 0 && lanes > 0 &&
         lanes <= kMaxLanes && (lanes & (lanes - 1)) == 0 &&
         rows > 0 && rows <= kMaxRows;
}

Params params(int batch, int T, int H, int W, int C) {
  Params p;
  p.T = T;
  p.H = H;
  p.W = W;
  p.C = C;
  p.items = (int64_t)batch * T * H;
  p.x_sb = p.x_sn = p.dy_sb = p.dy_sn = 0;
  return p;
}

}  // namespace

extern "C" {

// y = the conv of x (forward).  x: (batch, T*H*W, C) fp32 with unit channel
// stride, batch stride x_sb and token stride x_sn; weight (C, 1, 3, 3, 3)
// and bias (C,) fp32 contiguous, bias may be null; y (batch, T*H*W, C) fp32
// contiguous.  vec: channels per thread, 4 (C, x_sb and x_sn multiples of 4,
// x 16-byte aligned) or 1; lanes: blockDim.x, a power of two up to 32;
// rows: grid y, 1 to 65535.  Returns
// cudaGetLastError() after the launch (0 = success).
int vivim_dwconv3d_fwd(const void* x, const void* weight, const void* bias,
                       void* y, int batch, int T, int H, int W, int C,
                       int64_t x_sb, int64_t x_sn, int vec, int lanes,
                       int rows, void* stream) {
  if (!shape_ok(batch, T, H, W, C, lanes, rows) ||
      (vec != 1 && vec != 4) || C % vec != 0)
    return (int)cudaErrorInvalidValue;
  Params p = params(batch, T, H, W, C);
  p.x_sb = x_sb;
  p.x_sn = x_sn;
  const int64_t tiles = ((int64_t)C / vec + lanes - 1) / lanes;
  const dim3 grid((unsigned)tiles, (unsigned)rows);
  const dim3 block(lanes, kThreads / lanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(weight);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  if (vec == 4)
    dwconv3d_fwd_kernel<4><<<grid, block, 0, st>>>(xf, wf, bf, yf, p);
  else
    dwconv3d_fwd_kernel<1><<<grid, block, 0, st>>>(xf, wf, bf, yf, p);
  return (int)cudaGetLastError();
}

// dx, dweight and dbias of the conv (backward), from x and dy (batch,
// T*H*W, C) fp32 with unit channel stride and the given batch and token
// strides, and the weight (C, 1, 3, 3, 3).  dx is written (batch, T*H*W, C)
// contiguous, dweight (C, 1, 3, 3, 3) and dbias (C,) (dbias may be null);
// `part` holds rows * 28 * C fp32 elements of scratch.  lanes and rows as
// in vivim_dwconv3d_fwd (one channel per thread).  Returns
// cudaGetLastError() after the two launches (0 = success).
int vivim_dwconv3d_bwd(const void* x, const void* dy, const void* weight,
                       void* dx, void* dweight, void* dbias, void* part,
                       int batch, int T, int H, int W, int C, int64_t x_sb,
                       int64_t x_sn, int64_t dy_sb, int64_t dy_sn, int lanes,
                       int rows, void* stream) {
  if (!shape_ok(batch, T, H, W, C, lanes, rows))
    return (int)cudaErrorInvalidValue;
  Params p = params(batch, T, H, W, C);
  p.x_sb = x_sb;
  p.x_sn = x_sn;
  p.dy_sb = dy_sb;
  p.dy_sn = dy_sn;
  const int64_t tiles = ((int64_t)C + lanes - 1) / lanes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  dwconv3d_bwd_kernel<<<dim3((unsigned)tiles, (unsigned)rows),
                        dim3(lanes, kThreads / lanes), 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const float*>(weight), static_cast<float*>(dx), pf, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t outs = (int64_t)kPart * C;
  dwconv3d_bwd_sum_kernel<<<(unsigned)((outs + kThreads - 1) / kThreads),
                            kThreads, 0, st>>>(
      pf, static_cast<float*>(dweight), static_cast<float*>(dbias), rows, C);
  return (int)cudaGetLastError();
}

const char* vivim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
