// Dense preamble detection metrics from staged window tiles, for Hopper
// (sm_90a): the "tile" variant of the detection metric.
//
// Replaces the TPU kernel lora_tpu/ops/pallas_kernels.py:_det_kernel (with
// its caller _det_call, reached through detection_metrics_pallas(...,
// variant="tile")). It computes what det_metrics.cu computes, for float32
// planes x[C, 2, L] viewed as rows of sps samples (K1 = L / sps rows):
//
//   e_k    = sum_t |x_k[t]|^2                           (every row k < K1)
//   dot_k  = sum_t x_k[t] * conj(x_{k+1}[t])            (k < K = K1 - 1)
//   corr_k = |dot_k| / sqrt(e_k * e_{k+1}), 0 where the denominator is 0
//
// and writes corr[C, K] and the row energies ener[C, K1] in float32.
//
// What bounds it: device-memory bytes, as for det_metrics.cu: the block is
// read once (C * 2 * L * 4 bytes; the dense bench block's 1.07 GB is 0.32
// ms at the H100 SXM data-sheet 3.35 TB/s). Its 12 flops a complex sample
// are two orders of magnitude under the float32 rate at that intensity.
//
// Design: the staged counterpart of det_metrics.cu. That kernel reads rows
// straight from device memory and leaves the one-row overlap between its
// warps to L1/L2; this one stages every byte it reduces in shared memory
// first. A block owns (channel, T = 16 windows). It walks the columns of
// its rows in slabs of W = 256: for each slab it copies the [2, T+1, W]
// float32 block (both planes, its T rows plus the next tile's first row)
// into one of two shared-memory buffers with cp.async (16 bytes a copy
// where the planes are aligned, 4 bytes otherwise; zeros past the last row
// and past sps), so the next slab's copy is in flight while the current
// one is reduced. Thread t reduces column t of the slab down its T+1
// rows, keeping the previous row's samples in registers: every staged
// sample is read once from shared memory, each row's energy is summed
// once and each adjacent pair's conj-dot once. The 3T+1 partial sums of a
// thread carry across slabs in registers; after the last slab they are
// summed over the block (warp shuffles, then shared memory) and the block
// writes its T outputs. Any sps >= 1 and any window count are taken:
// there is no gate and no tail that the wrapper computes elsewhere.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 16;                 // windows per block
constexpr int kRows = kT + 1;          // plus the next tile's first row
constexpr int kW = 256;                // columns per slab = threads per block
constexpr int kThreads = kW;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 3 * kT + 1;      // kRows energies, kT dot re, kT dot im
constexpr int kSlabFloats = 2 * kRows * kW;
constexpr size_t kSmemBytes = 2 * kSlabFloats * sizeof(float);  // two buffers

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Start the copies of slab s ([2][kRows][kW], plane-major) into buf: V
// consecutive floats a copy; V = 4 needs 16-byte aligned rows (the wrapper
// checks the base pointer, L and sps). Elements past sps or past the last
// row are written as zeros, so the reduction needs no masks.
template <int V>
__device__ __forceinline__ void stage_slab(float* buf, const float* re, const float* im,
                                           int64_t k0, int64_t K1, int64_t sps, int64_t s) {
  constexpr int kChunks = kW / V;                 // copies a row
  const int64_t col0 = s * kW;
  for (int i = threadIdx.x; i < 2 * kRows * kChunks; i += kThreads) {
    const int p = i / (kRows * kChunks);
    const int rem = i - p * kRows * kChunks;
    const int j = rem / kChunks;
    const int v = rem - j * kChunks;
    const int64_t k = k0 + j;
    const int64_t col = col0 + (int64_t)v * V;
    float* dst = buf + (p * kRows + j) * kW + v * V;
    if (k < K1 && col < sps) {  // V = 4: sps % 4 == 0, so the chunk is whole
      const float* src = (p == 0 ? re : im) + k * sps + col;
      if constexpr (V == 4)
        cp_async_16(dst, src);
      else
        cp_async_4(dst, src);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) dst[q] = 0.f;
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
det_tile_kernel(const float* __restrict__ x, float* __restrict__ corr,
                float* __restrict__ ener, int64_t L, int64_t sps, int64_t K1,
                int64_t tiles) {
  extern __shared__ __align__(16) float smem[];   // two slabs of [2][kRows][kW]
  __shared__ float s_red[kWarps][kSums];

  const int64_t c = blockIdx.x / tiles;
  const int64_t k0 = (blockIdx.x % tiles) * kT;
  const float* re = x + c * 2 * L;
  const float* im = re + L;
  const int t = threadIdx.x;
  const int64_t n_slabs = (sps + kW - 1) / kW;

  float e[kRows], dre[kT], dim[kT];
#pragma unroll
  for (int j = 0; j < kRows; ++j) e[j] = 0.f;
#pragma unroll
  for (int j = 0; j < kT; ++j) dre[j] = dim[j] = 0.f;

  stage_slab<V>(smem, re, im, k0, K1, sps, 0);
  cp_async_commit();
  for (int64_t s = 0; s < n_slabs; ++s) {
    if (s + 1 < n_slabs) {
      stage_slab<V>(smem + ((s + 1) & 1) * kSlabFloats, re, im, k0, K1, sps, s + 1);
      cp_async_commit();
      cp_async_wait<1>();   // slab s has landed; s + 1 stays in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* b = smem + (s & 1) * kSlabFloats;
    float a_re = b[t], a_im = b[kRows * kW + t];
    e[0] += a_re * a_re + a_im * a_im;
#pragma unroll
    for (int j = 1; j < kRows; ++j) {
      const float n_re = b[j * kW + t];
      const float n_im = b[(kRows + j) * kW + t];
      e[j] += n_re * n_re + n_im * n_im;
      dre[j - 1] += a_re * n_re + a_im * n_im;
      dim[j - 1] += a_im * n_re - a_re * n_im;
      a_re = n_re;
      a_im = n_im;
    }
    __syncthreads();        // buffer s & 1 is refilled by the copy of slab s + 2
  }

  const int warp = t >> 5, lane = t & 31;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const float v = warp_sum(e[j]);
    if (lane == 0) s_red[warp][j] = v;
  }
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    const float vr = warp_sum(dre[j]);
    const float vi = warp_sum(dim[j]);
    if (lane == 0) {
      s_red[warp][kRows + j] = vr;
      s_red[warp][kRows + kT + j] = vi;
    }
  }
  __syncthreads();
  float* tot = smem;        // the slab buffers are free now
  if (t < kSums) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += s_red[w][t];
    tot[t] = v;
  }
  __syncthreads();
  if (t < kT) {
    const int64_t k = k0 + t;
    if (k < K1) ener[c * K1 + k] = tot[t];
    if (k + 1 < K1) {
      const float d_re = tot[kRows + t], d_im = tot[kRows + kT + t];
      const float denom = sqrtf(tot[t] * tot[t + 1]);
      const float mag = sqrtf(d_re * d_re + d_im * d_im);
      corr[c * (K1 - 1) + k] = denom > 0.f ? mag / denom : 0.f;
    }
  }
}

template <int V>
int launch(const void* x, void* corr, void* ener, int64_t L, int64_t sps, int64_t K1,
           int64_t tiles, int64_t blocks, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory only after this opt-in (per
  // device, so it is made at every launch; it costs a host call)
  const cudaError_t attr = cudaFuncSetAttribute(
      det_tile_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  det_tile_kernel<V><<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(corr), static_cast<float*>(ener),
      L, sps, K1, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x: float32 planes [C, 2, L], contiguous, on the calling thread's current
// CUDA device. corr: float32 [C, L/sps - 1]; ener: float32 [C, L/sps].
// Launches on `stream` without synchronising and returns the launch's
// cudaError_t.
extern "C" int det_tile_launch(const void* x, void* corr, void* ener, long long C,
                               long long L, long long sps, void* stream) {
  if (C < 1 || sps < 1 || L < 2 * sps) return (int)cudaErrorInvalidValue;
  const int64_t K1 = L / sps;
  const int64_t tiles = (K1 + kT - 1) / kT;
  const int64_t blocks = tiles * C;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (aligned && L % 4 == 0 && sps % 4 == 0)
    return launch<4>(x, corr, ener, L, sps, K1, tiles, blocks, s);
  return launch<1>(x, corr, ener, L, sps, K1, tiles, blocks, s);
}

extern "C" const char* det_tile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
