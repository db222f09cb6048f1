// Preamble detection metrics on window-major IQ, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/profile_packing.py:_det_kernel_wm (with its
// caller det_wm), the layout experiment that stores each symbol window's
// two planes together. Input x[C, K1, 2, sps] float32: window k of channel
// c is the contiguous span x[c, k] = [re (sps) | im (sps)]. For every
// window k < K1:
//
//   e_k    = sum_t |x_k[t]|^2
//   dot_k  = sum_t x_k[t] * conj(x_n[t]),  n = k + 1, or k for the last
//   corr_k = |dot_k| / sqrt(e_k * e_n), 0 where the denominator is 0
//
// and writes corr[C, K1] and ener[C, K1] in float32. The last window is
// paired with itself (the TPU kernel's next-row block is clamped to the
// last row), so its corr is 1 where its energy is > 0.
//
// What bounds it: device-memory bytes, as for det_metrics.cu: the block is
// read once (C * K1 * 2 * sps * 4 bytes, 1.07 GB for the dense bench
// block's samples, 0.32 ms at the H100 SXM data-sheet 3.35 TB/s).
//
// Design. The grid is one block per (channel, tile of T = 32 windows).
// Its T windows and the next one are one contiguous span of (T+1) * 2 *
// sps floats, so every warp streams whole rows front to back: a warp takes
// one window at a time and reduces it against the window after it with
// float32 accumulators in registers, 16-byte loads where the span is
// aligned (sps a multiple of 4 and an aligned base), scalar loads
// otherwise; the loop bound masks the ragged edge. The next window of a
// warp's window is the current window of another warp of the same block,
// so the second read is served from L1/L2. Each window's energy is summed
// once, into shared memory; after one barrier the block writes corr and
// the energies. Any sps >= 1 and any window count are taken: no tile
// divisibility, no gate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // windows per block

template <int V>
struct Loader;

template <>
struct Loader<1> {
  __device__ __forceinline__ static void load(const float* p, int64_t v, float out[1]) {
    out[0] = p[v];
  }
};

template <>
struct Loader<4> {
  __device__ __forceinline__ static void load(const float* p, int64_t v, float out[4]) {
    const float4 q = reinterpret_cast<const float4*>(p)[v];
    out[0] = q.x;
    out[1] = q.y;
    out[2] = q.z;
    out[3] = q.w;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
det_wm_kernel(const float* __restrict__ x, float* __restrict__ corr,
              float* __restrict__ ener, int64_t K1, int64_t sps, int64_t tiles) {
  __shared__ float s_e[kTile + 1];
  __shared__ float s_re[kTile];
  __shared__ float s_im[kTile];

  const int64_t c = blockIdx.x / tiles;
  const int64_t k0 = (blockIdx.x % tiles) * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* xc = x + c * K1 * 2 * sps;
  const int64_t nv = sps / V;
  const int64_t left = K1 - k0;
  // the tile's windows plus the next tile's first, whose energy the last
  // window's corr needs
  const int rows = left < kTile + 1 ? (int)left : kTile + 1;

  for (int j = warp; j < rows; j += kWarps) {
    const int64_t k = k0 + j;
    const bool has_dot = j < kTile;
    const int64_t n = k + 1 < K1 ? k + 1 : k;   // the last window pairs with itself
    const float* rk = xc + k * 2 * sps;
    const float* ik = rk + sps;
    const float* rn = xc + n * 2 * sps;
    const float* in = rn + sps;
    float e = 0.f, dre = 0.f, dim = 0.f;
    for (int64_t v = lane; v < nv; v += 32) {
      float a[V], b[V];
      Loader<V>::load(rk, v, a);
      Loader<V>::load(ik, v, b);
#pragma unroll
      for (int q = 0; q < V; ++q) e += a[q] * a[q] + b[q] * b[q];
      if (has_dot) {
        float cn[V], dn[V];
        Loader<V>::load(rn, v, cn);
        Loader<V>::load(in, v, dn);
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
      if (has_dot) {
        s_re[j] = dre;
        s_im[j] = dim;
      }
    }
  }
  __syncthreads();

  const int j = threadIdx.x;
  if (j < kTile && j < left) {
    const int64_t k = k0 + j;
    const float en = k + 1 < K1 ? s_e[j + 1] : s_e[j];
    ener[c * K1 + k] = s_e[j];
    const float denom = sqrtf(s_e[j] * en);
    const float mag = sqrtf(s_re[j] * s_re[j] + s_im[j] * s_im[j]);
    corr[c * K1 + k] = denom > 0.f ? mag / denom : 0.f;
  }
}

template <int V>
void launch(const void* x, void* corr, void* ener, int64_t K1, int64_t sps, int64_t tiles,
            int64_t blocks, cudaStream_t stream) {
  det_wm_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(corr), static_cast<float*>(ener),
      K1, sps, tiles);
}

}  // namespace

// x: float32 window-major IQ [C, K1, 2, sps], contiguous, on the calling
// thread's current CUDA device. corr, ener: float32 [C, K1]. Launches on
// `stream` without synchronising and returns the launch's cudaError_t.
extern "C" int det_wm_launch(const void* x, void* corr, void* ener, long long C,
                             long long K1, long long sps, void* stream) {
  if (C < 1 || K1 < 1 || sps < 1) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (K1 + kTile - 1) / kTile;
  const int64_t blocks = tiles * C;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0 && sps % 4 == 0)
    launch<4>(x, corr, ener, K1, sps, tiles, blocks, s);
  else
    launch<1>(x, corr, ener, K1, sps, tiles, blocks, s);
  return (int)cudaGetLastError();
}

extern "C" const char* det_wm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
