// Multi-lag fine-row detection substrate on packed IQ planes, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel lora_tpu/ops/pallas_kernels.py:_lag_rows_kernel
// (with its callers _lag_rows_call and lag_rows_pallas). For every channel
// c of packed planes x[C, 2, L] (float32 or bfloat16), rows of sps samples
// (row r starts at r * sps, R = L / sps rows) and a sorted set of lags
// l >= 1:
//
//   e[r]   = sum_t |x_r[t]|^2
//   q_l[r] = sum_t x_r[t] * conj(x_{r+l}[t])       (0 for r >= R - l)
//
// written as out[C, 1 + 2 * n_lags, R] float32: row 0 the energies, rows
// 1 + 2s and 2 + 2s lag s's real and imaginary parts. Sums are float32
// whatever the load type. Every spreading factor's symbol is a whole
// number m of the smallest SF's, so one pass gives every SF's adjacent-
// window metrics (sums of m consecutive rows of e and q_m), where the
// per-SF detection kernel would read the planes once per SF.
//
// What bounds it: device-memory bytes. It must read the planes once,
// C * 2 * L * itemsize bytes, and write C * (1 + 2 * n_lags) * R floats:
// at the gateway's shape (256 channels x 450,551 bf16 samples, rows of
// 256, lags 1..32) that is 461 MB + 23 MB, 0.145 ms at the H100 SXM data
// sheet's 3.35 TB/s, against about 6 GFLOP (0.09 ms at 67 TFLOP/s).
//
// Design. One block per (channel, run of 256 consecutive rows); each
// lane of its 8 warps owns one row and sums the row's energy and its
// lag products itself, so no sum crosses lanes and the result is
// deterministic. The block walks the row length in column tiles of 8
// samples, staging its run and the 32 rows after it (the halo the
// largest SF lag needs, 1/8 of the run) into shared memory as float32
// (re, im) pairs, rows padded by one pair so that 16 lanes reading 16
// rows at one column hit distinct banks. Each thread loads its 9
// elements of a tile with all loads in flight at once, and loads the
// next tile while the block sums the current one. A lane keeps 13 sums
// (the energy and six lags' products; larger lag sets take further
// passes of six), summed a tile at a time before they join the row's,
// and three blocks fit an SM. Tile width, prefetch and blocks an SM were
// chosen by timing their variants at the gateway's shape
// (tune/lag_rows_variants.py). A partner row past the
// staged halo (a lag above 32) is read from device memory directly, in a
// second instantiation that only such lag sets launch. Any sps, lag set,
// row count (ragged R, lags >= R) and channel count is taken here;
// nothing is routed elsewhere. Loads are scalar: the gateway's planes
// have an odd length, so no vector, cp.async or TMA alignment holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRun = kThreads;               // rows a block owns: one a lane
constexpr int kHalo = 32;                    // rows staged after the run
constexpr int kStageRows = kRun + kHalo;
constexpr int kCols = 8;                     // column tile
constexpr int kPitch = kCols + 1;            // padded row of the staged tile
constexpr int kPerThread = kStageRows * kCols / kThreads;  // staged elements a thread loads
constexpr int kLagChunk = 6;                 // lags summed in registers at once
constexpr int kMinBlocks = 3;                // blocks an SM: caps registers at 85
static_assert(kThreads % kCols == 0 && kStageRows * kCols % kThreads == 0,
              "every thread stages the same number of a tile's elements");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// This thread's elements of the tile at column t0: rows r0 + j,
// j = threadIdx.x / kCols + m * (kThreads / kCols), at column t0 +
// threadIdx.x % kCols, as (re, im); zero past row R and past the row end.
// All loads are issued before any is used.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ re, const T* __restrict__ im,
                                          int64_t r0, int64_t t0, int64_t sps, int64_t R,
                                          float2 v[kPerThread]) {
  const int64_t t = t0 + threadIdx.x % kCols;
#pragma unroll
  for (int m = 0; m < kPerThread; ++m) {
    const int64_t r = r0 + threadIdx.x / kCols + m * (kThreads / kCols);
    const bool in = r < R && t < sps;
    v[m].x = in ? to_f32(re[r * sps + t]) : 0.f;
    v[m].y = in ? to_f32(im[r * sps + t]) : 0.f;
  }
}

// kFar: some lag reaches past the staged halo; its partner rows are read
// from device memory.
template <typename T, bool kFar>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lag_rows_kernel(const T* __restrict__ x, const int* __restrict__ lags,
                float* __restrict__ out, int64_t L, int64_t sps, int64_t R,
                int n_lags, int64_t runs) {
  __shared__ float2 s_x[kStageRows][kPitch];

  const int64_t c = blockIdx.x / runs;
  const int64_t r0 = (blockIdx.x % runs) * kRun;
  const int j = threadIdx.x;                 // this lane's row in the run
  const int64_t r = r0 + j;
  const T* re = x + c * 2 * L;
  const T* im = re + L;
  float* o = out + c * (1 + 2 * (int64_t)n_lags) * R;

  for (int g0 = 0; g0 < n_lags; g0 += kLagChunk) {
    const int ng = min(kLagChunk, n_lags - g0);
    // an unused slot pairs the row with itself; its sums are not written
    int lag[kLagChunk];
#pragma unroll
    for (int k = 0; k < kLagChunk; ++k) lag[k] = k < ng ? lags[g0 + k] : 0;
    float acc_e = 0.f, acc_re[kLagChunk], acc_im[kLagChunk];
#pragma unroll
    for (int k = 0; k < kLagChunk; ++k) acc_re[k] = acc_im[k] = 0.f;

    float2 v[kPerThread];
    load_tile(re, im, r0, 0, sps, R, v);
    for (int64_t t0 = 0; t0 < sps; t0 += kCols) {
      __syncthreads();  // the previous tile is consumed
#pragma unroll
      for (int m = 0; m < kPerThread; ++m)
        s_x[threadIdx.x / kCols + m * (kThreads / kCols)][threadIdx.x % kCols] = v[m];
      __syncthreads();
      if (t0 + kCols < sps) load_tile(re, im, r0, t0 + kCols, sps, R, v);  // in flight during the sums

      // the tile's sums first, then into the row's: float32 error grows
      // with kCols + sps / kCols terms, not with sps
      float te = 0.f, tre[kLagChunk], tim[kLagChunk];
#pragma unroll
      for (int k = 0; k < kLagChunk; ++k) tre[k] = tim[k] = 0.f;
#pragma unroll
      for (int col = 0; col < kCols; ++col) {
        const float2 a = s_x[j][col];
        te = fmaf(a.x, a.x, fmaf(a.y, a.y, te));
#pragma unroll
        for (int k = 0; k < kLagChunk; ++k) {
          const int jj = j + lag[k];
          float2 p;
          if (!kFar || jj < kStageRows) {
            p = s_x[jj][col];
          } else {  // a partner past the staged halo: straight from memory
            const int64_t rr = r0 + jj;
            const int64_t t = t0 + col;
            const bool in = rr < R && t < sps;
            p.x = in ? to_f32(re[rr * sps + t]) : 0.f;
            p.y = in ? to_f32(im[rr * sps + t]) : 0.f;
          }
          tre[k] = fmaf(a.x, p.x, fmaf(a.y, p.y, tre[k]));
          tim[k] = fmaf(a.y, p.x, fmaf(-a.x, p.y, tim[k]));
        }
      }
      acc_e += te;
#pragma unroll
      for (int k = 0; k < kLagChunk; ++k) {
        acc_re[k] += tre[k];
        acc_im[k] += tim[k];
      }
    }

    if (r < R) {
      if (g0 == 0) o[r] = acc_e;
#pragma unroll
      for (int k = 0; k < kLagChunk; ++k) {
        if (k < ng) {
          o[(1 + 2 * (int64_t)(g0 + k)) * R + r] = acc_re[k];
          o[(2 + 2 * (int64_t)(g0 + k)) * R + r] = acc_im[k];
        }
      }
    }
  }
}

template <typename T>
void launch(const void* x, const int* lags, float* out, int64_t L, int64_t sps, int64_t R,
            int n_lags, bool far, int64_t runs, int64_t blocks, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (far)
    lag_rows_kernel<T, true><<<(unsigned)blocks, kThreads, 0, s>>>(xt, lags, out, L, sps, R,
                                                                   n_lags, runs);
  else
    lag_rows_kernel<T, false><<<(unsigned)blocks, kThreads, 0, s>>>(xt, lags, out, L, sps, R,
                                                                    n_lags, runs);
}

}  // namespace

// x: planes [C, 2, L] (dtype 0 = float32, 1 = bfloat16), contiguous;
// lags: n_lags sorted, unique int32 lags >= 1 in device memory, the
// largest max_lag; out: float32 [C, 1 + 2 * n_lags, L / sps]. All on the
// calling thread's current CUDA device. Launches on `stream` without
// synchronising and returns the launch's cudaError_t.
extern "C" int lag_rows_launch(const void* x, const void* lags, void* out,
                               long long C, long long L, long long sps,
                               int n_lags, int max_lag, int dtype, void* stream) {
  if (C < 1 || sps < 1 || L < sps || n_lags < 1 || max_lag < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t R = L / sps;
  const int64_t runs = (R + kRun - 1) / kRun;
  const int64_t blocks = runs * C;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lg = static_cast<const int*>(lags);
  float* o = static_cast<float*>(out);
  const bool far = max_lag > kHalo;
  if (dtype == 0)
    launch<float>(x, lg, o, L, sps, R, n_lags, far, runs, blocks, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(x, lg, o, L, sps, R, n_lags, far, runs, blocks, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* lag_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
