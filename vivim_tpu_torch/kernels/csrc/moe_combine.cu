// The dropless MoE block's combine over a whole sequence, for Hopper
// (sm_90a): each token's gated expert outputs and its shared expert's output,
// summed into one row in the compute dtype.
//
// Replaces no TPU kernel: the JAX package has no dropless block.  In plain
// PyTorch (nn/moe.py::dropless_moe before this kernel) the combine was an
// fp32 copy of every sorted expert output row, an fp32 product with its
// gate, an index_add_ with atomics into a zeroed fp32 (T, M) sum, an fp32
// add of the shared expert's output and a cast: at Granite 4.0-H-Small's
// prefill (T 32,768 tokens, top-10, M 4096, bf16) about 25 GB of traffic a
// layer.  This kernel reads what the combine needs, once:
//
//   out[t, :] = round(sum_{j < k} gates[t, j] * float(ys[pos[t, j], :])
//                     + float(shared[t, :]))
//
// where ys (T k, M) are the expert outputs in expert-sorted order, pos (T, k)
// int32 the sorted row of each token's j-th choice (the inverse of the
// sort), gates (T, k) fp32 in token order and shared (T, M) the shared
// expert's output (or none).  Every product and sum is one fp32 operation
// rounded on its own (__fmul_rn, __fadd_rn: nothing is contracted into an
// fma), taken in the fixed order j = 0 .. k-1 and then the shared row, and
// the result is rounded once to the output's dtype: the same arithmetic, in
// the same order, as moe_combine.py::plain_moe_combine, and the same on every
// run (no atomics).  ys, shared and out share one dtype, fp32 or bf16.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  Granite's prefill layer reads ys
// (2.68 GB) and shared (0.27 GB) and writes out (0.27 GB): 0.96 ms.  Design:
// one thread a 16-byte column vector of one token's row (8 bf16 or 4 fp32
// values; one value where M or a pointer is not 16-byte aligned), threads of
// a block on neighbouring vectors, so a warp's loads of a row are contiguous
// 512-byte runs.  A thread reads its token's k rows and gates (the block's
// threads read the same ones: broadcast), then issues the k row loads and
// the shared one before it sums any, so that up to k + 1 16-byte loads a
// thread are in flight; a thread has registers for the fewest of 2, 4, 8 or
// 16 choices that hold k (launch_v), so that a small k leaves room for more
// threads an SM.  Nothing is staged in shared memory, there is no barrier,
// and out is written once, never zero-filled.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxK = 16;        // choices a token
constexpr int kF32 = 0, kBF16 = 1;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// V values of T, loaded and stored as one access (16 bytes where V * sizeof
// T is 16)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// K: the choices a thread has registers for, k <= K
template <typename T, int V, int K>
__global__ void __launch_bounds__(kThreads)
    moe_combine_kernel(const T* __restrict__ ys, const int* __restrict__ pos,
                       const float* __restrict__ gates,
                       const T* __restrict__ shared, T* __restrict__ out,
                       int64_t tokens, int k, int64_t m) {
  using P = Pack<T, V>;
  const int64_t vecs = m / V;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= tokens * vecs) return;
  const int64_t t = i / vecs;
  const int64_t col = (i - t * vecs) * V;
  int row[K];
  float g[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < k) {
      row[j] = pos[t * k + j];
      g[j] = gates[t * k + j];
    }
  }
  P y[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < k)
      y[j] = *reinterpret_cast<const P*>(ys + (int64_t)row[j] * m + col);
  }
  P s;
  if (shared != nullptr)
    s = *reinterpret_cast<const P*>(shared + t * m + col);
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < k) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc[v] = __fadd_rn(acc[v], __fmul_rn(g[j], to_float(y[j].v[v])));
    }
  }
  if (shared != nullptr) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = __fadd_rn(acc[v], to_float(s.v[v]));
  }
  P o;
#pragma unroll
  for (int v = 0; v < V; ++v) from_float(acc[v], &o.v[v]);
  *reinterpret_cast<P*>(out + t * m + col) = o;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int V, int K>
void launch_k(const T* ys, const int* pos, const float* gates,
              const T* shared, T* out, int64_t tokens, int k, int64_t m,
              unsigned blocks, cudaStream_t stream) {
  moe_combine_kernel<T, V, K><<<blocks, kThreads, 0, stream>>>(
      ys, pos, gates, shared, out, tokens, k, m);
}

// The kernel with registers for the fewest choices of 2, 4, 8 or 16 that
// hold k: a thread's registers for unused choices would cut the threads an
// SM holds, and so the loads in flight (at top-2 of Jamba's prefill, K 16
// took 144 registers a thread and reached 35 % of the bytes bound).
template <typename T, int V>
void launch_v(const T* ys, const int* pos, const float* gates,
              const T* shared, T* out, int64_t tokens, int k, int64_t m,
              unsigned blocks, cudaStream_t stream) {
  if (k <= 2)
    launch_k<T, V, 2>(ys, pos, gates, shared, out, tokens, k, m, blocks,
                      stream);
  else if (k <= 4)
    launch_k<T, V, 4>(ys, pos, gates, shared, out, tokens, k, m, blocks,
                      stream);
  else if (k <= 8)
    launch_k<T, V, 8>(ys, pos, gates, shared, out, tokens, k, m, blocks,
                      stream);
  else
    launch_k<T, V, kMaxK>(ys, pos, gates, shared, out, tokens, k, m, blocks,
                          stream);
}

template <typename T>
int launch(const void* ys, const int* pos, const float* gates,
           const void* shared, void* out, int64_t tokens, int k, int64_t m,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool wide = m % kVec == 0 && aligned16(ys) && aligned16(out) &&
                    (shared == nullptr || aligned16(shared));
  const int64_t threads = tokens * (wide ? m / kVec : m);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const auto* y = static_cast<const T*>(ys);
  const auto* s = static_cast<const T*>(shared);
  auto* o = static_cast<T*>(out);
  if (wide)
    launch_v<T, kVec>(y, pos, gates, s, o, tokens, k, m, (unsigned)blocks,
                      stream);
  else
    launch_v<T, 1>(y, pos, gates, s, o, tokens, k, m, (unsigned)blocks,
                   stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The combine.  ys (tokens * k, m), shared (tokens, m; may be null) and out
// (tokens, m) contiguous, of dtype code `type` (0 fp32, 1 bf16); pos (tokens,
// k) int32 and gates (tokens, k) fp32 contiguous, every pos in [0, tokens *
// k).  tokens >= 1, k 1 to 16, m >= 1.  Returns cudaGetLastError() after the
// launch (0 = success).
int vivim_moe_combine(const void* ys, const int* pos, const float* gates,
                      const void* shared, void* out, int type, int64_t tokens,
                      int k, int64_t m, void* stream) {
  if (tokens < 1 || k < 1 || k > kMaxK || m < 1)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (type == kF32)
    return launch<float>(ys, pos, gates, shared, out, tokens, k, m, st);
  if (type == kBF16)
    return launch<__nv_bfloat16>(ys, pos, gates, shared, out, tokens, k, m,
                                 st);
  return (int)cudaErrorInvalidValue;
}

const char* vivim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
