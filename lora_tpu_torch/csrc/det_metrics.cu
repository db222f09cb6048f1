// Dense preamble detection metrics on packed IQ planes, for Hopper (sm_90a).
//
// Replaces the TPU kernel lora_tpu/ops/pallas_kernels.py:_det_kernel_pp
// (with its caller _det_call_pp and detection_metrics_pallas). For every
// channel c and symbol-stride window k of packed planes x[C, 2, L]
// (float32 or bfloat16; rows of sps samples, K1 = L / sps rows):
//
//   e_k    = sum_t |x_k[t]|^2                           (every row k < K1)
//   dot_k  = sum_t x_k[t] * conj(x_{k+1}[t])            (k < K = K1 - 1)
//   corr_k = |dot_k| / sqrt(e_k * e_{k+1}), 0 where the denominator is 0
//
// and writes corr[C, K] and the row energies ener[C, K1] in float32; the
// caller's e1/e2 are the views ener[:, :K] and ener[:, 1:]. Sums are
// float32 whatever the load type.
//
// What bounds it: device-memory bytes. The kernel must read the block
// once, C * 2 * L * itemsize bytes; for the dense bench block (64 channels
// x 2048 symbols x 1024 samples, float32) that is 1.07 GB, 0.32 ms at the
// H100 SXM data-sheet 3.35 TB/s, half that for bfloat16. Its arithmetic
// (12 flops a complex sample) is two orders of magnitude under the card's
// float32 rate at that intensity.
//
// Design. The grid is one block per (channel, tile of T windows). A block
// reads rows k0 .. k0+T (clamped to K1-1): its own T rows plus one row of
// overlap, so device-memory traffic is one read per element plus 1/T.
// Each warp takes one window at a time and reduces over sps with float32
// accumulators in registers, 16-byte vector loads where the planes are
// aligned (float4 for float32, 8 x bfloat16), scalar loads otherwise; the
// loop bound masks the ragged edge. The next row of a window is also the
// current row of the next warp's window: both warps run in the same block
// at the same time, so the second load is served from L1/L2, not from
// device memory. Row energies go to shared memory and each is computed
// once; after one barrier the block writes corr and the energies. Any
// sps >= 1 and any window count are handled here: there is no geometry
// the wrapper has to route elsewhere. Pipelined copies (cp.async, TMA)
// are not used yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // windows per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Load group v of V consecutive elements of a row as float32.
template <typename T, int V>
struct Loader;

template <typename T>
struct Loader<T, 1> {
  __device__ __forceinline__ static void load(const T* p, int64_t v, float out[1]) {
    out[0] = to_f32(p[v]);
  }
};

template <>
struct Loader<float, 4> {
  __device__ __forceinline__ static void load(const float* p, int64_t v, float out[4]) {
    const float4 q = reinterpret_cast<const float4*>(p)[v];
    out[0] = q.x;
    out[1] = q.y;
    out[2] = q.z;
    out[3] = q.w;
  }
};

template <>
struct Loader<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, int64_t v, float out[8]) {
    const uint4 q = reinterpret_cast<const uint4*>(p)[v];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
det_metrics_kernel(const T* __restrict__ x, float* __restrict__ corr,
                   float* __restrict__ ener, int64_t L, int64_t sps,
                   int64_t K1, int64_t tiles) {
  __shared__ float s_e[kTile + 1];
  __shared__ float s_re[kTile];
  __shared__ float s_im[kTile];

  const int64_t c = blockIdx.x / tiles;
  const int64_t k0 = (blockIdx.x % tiles) * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* re = x + c * 2 * L;
  const T* im = re + L;
  const int64_t nv = sps / V;
  const int64_t left = K1 - k0;
  const int rows = left < kTile + 1 ? (int)left : kTile + 1;

  for (int j = warp; j < rows; j += kWarps) {
    const int64_t k = k0 + j;
    const bool has_dot = (j < kTile) && (k + 1 < K1);
    const T* rk = re + k * sps;
    const T* ik = im + k * sps;
    float e = 0.f, dre = 0.f, dim = 0.f;
    for (int64_t v = lane; v < nv; v += 32) {
      float a[V], b[V];
      Loader<T, V>::load(rk, v, a);
      Loader<T, V>::load(ik, v, b);
#pragma unroll
      for (int q = 0; q < V; ++q) e += a[q] * a[q] + b[q] * b[q];
      if (has_dot) {
        float cn[V], dn[V];
        Loader<T, V>::load(rk + sps, v, cn);
        Loader<T, V>::load(ik + sps, v, dn);
#pragma unroll
        for (int q = 0; q < V; ++q) {
          dre += a[q] * cn[q] + b[q] * dn[q];
          dim += b[q] * cn[q] - a[q] * dn[q];
        }
      }
    }
    e = warp_sum(e);
    dre = warp_sum(dre);
    dim = warp_sum(dim);
    if (lane == 0) {
      s_e[j] = e;
      if (j < kTile) {
        s_re[j] = dre;
        s_im[j] = dim;
      }
    }
  }
  __syncthreads();

  const int j = threadIdx.x;
  if (j < kTile) {
    const int64_t k = k0 + j;
    if (k < K1) ener[c * K1 + k] = s_e[j];
    if (k + 1 < K1) {
      const float denom = sqrtf(s_e[j] * s_e[j + 1]);
      const float mag = sqrtf(s_re[j] * s_re[j] + s_im[j] * s_im[j]);
      corr[c * (K1 - 1) + k] = denom > 0.f ? mag / denom : 0.f;
    }
  }
}

template <typename T, int V>
void launch(const void* x, void* corr, void* ener, int64_t L, int64_t sps,
            int64_t K1, int64_t tiles, int64_t blocks, cudaStream_t stream) {
  det_metrics_kernel<T, V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(corr),
      static_cast<float*>(ener), L, sps, K1, tiles);
}

}  // namespace

// x: planes [C, 2, L] (dtype 0 = float32, 1 = bfloat16), contiguous, on
// the calling thread's current CUDA device. corr: float32 [C, L/sps - 1];
// ener: float32 [C, L/sps]. Launches on `stream` without synchronising
// and returns the launch's cudaError_t.
extern "C" int det_metrics_launch(const void* x, void* corr, void* ener,
                                  long long C, long long L, long long sps,
                                  int dtype, void* stream) {
  if (C < 1 || sps < 1 || L < 2 * sps) return (int)cudaErrorInvalidValue;
  const int64_t K1 = L / sps;
  const int64_t tiles = (K1 + kTile - 1) / kTile;
  const int64_t blocks = tiles * C;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (dtype == 0) {
    if (aligned && L % 4 == 0 && sps % 4 == 0)
      launch<float, 4>(x, corr, ener, L, sps, K1, tiles, blocks, s);
    else
      launch<float, 1>(x, corr, ener, L, sps, K1, tiles, blocks, s);
  } else if (dtype == 1) {
    if (aligned && L % 8 == 0 && sps % 8 == 0)
      launch<__nv_bfloat16, 8>(x, corr, ener, L, sps, K1, tiles, blocks, s);
    else
      launch<__nv_bfloat16, 1>(x, corr, ener, L, sps, K1, tiles, blocks, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* det_metrics_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
