// Polyphase branch FIR on packed wideband planes, for Hopper (sm_90a).
//
// Replaces the TPU kernel lora_tpu/ops/pallas_kernels.py:_pfb_fir_kernel
// (with its caller _pfb_fir_call and pfb_fir_pallas). The planes x[2, L]
// (float32 or bfloat16; plane p starts at x + p * x_plane) are viewed as
// [2, n_vec, M], n_vec = L / M, and for every plane p, output row
// t < n_out = n_vec - K + 1 and branch m < M:
//
//   out[p, t, m] = sum_{j < K} h[j, m] * x[p, t + j, m]
//
// with float32 taps h[K, M], summed in float32 for j = 0 .. K-1 in that
// order, one multiply and one add each (no fused multiply-add), so the
// result is bit-equal to the plain version pfb_fir_planes; the output is
// float32 or bfloat16 (rounded to nearest even once). The output element
// (p, t, m) is written at out + p * out_plane + t * out_row + m: the
// wrapper picks the [n_out, 2, M] layout, whose rows [fr | fi] the DFT
// product reads without a copy.
//
// What bounds it: device-memory bytes. It must read the planes once and
// write the output once: at the wideband bench shape (M = 1024, n_vec =
// 24,576, K = 10) 201.3 MB in and 201.2 MB out in float32, 0.120 ms at the
// H100 SXM data-sheet 3.35 TB/s. Its 2 flops a tap and output (1 GFLOP)
// do not bind it.
//
// Design. One thread owns one branch m and kRows consecutive output rows,
// with their float32 sums in registers. The taps go in passes of kTaps:
// a pass holds the pass's taps of the thread's branch in registers, loads
// the kRows + kTaps - 1 input rows the pass touches into a register window
// (each once, straight from device memory, all issued before the first is
// used, so they are in flight together), then adds every row into every
// output row it feeds; the loops are unrolled, so the window and the sums
// stay in registers. A warp's 32 threads own 32 neighbouring branches, so
// every load and store is coalesced along m. Neighbouring blocks take
// neighbouring row tiles of the same branches, so the K - 1 rows two tiles
// share come from L2, and each input element is read from device memory
// about once (the plain version reads it K times). Any M >= 1, n_vec >= K
// and K >= 1 is taken: a ragged branch tile masks its last threads, a
// ragged row tile its last rows, and a K past kTaps takes more passes;
// there is no geometry the wrapper has to route elsewhere. Pipelined
// copies (cp.async, TMA) and wider loads are not used yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;                 // branches per block, one a thread
constexpr int kRows = 32;                  // output rows per thread
constexpr int kTaps = 16;                  // taps per pass
constexpr int kSpan = kRows + kTaps - 1;   // input rows a full pass reads

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kCols)
pfb_fir_kernel(const Tin* __restrict__ x, const float* __restrict__ h,
               Tout* __restrict__ out, int64_t M, int64_t K, int64_t n_vec,
               int64_t n_out, int64_t x_plane, int64_t out_plane,
               int64_t out_row) {
  const int64_t t0 = (int64_t)blockIdx.x * kRows;
  const int64_t m = (int64_t)blockIdx.y * kCols + threadIdx.x;
  const int p = blockIdx.z;
  if (m >= M) return;  // no barrier below: masked threads may leave
  const Tin* xc = x + p * x_plane + m;

  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;

  for (int64_t j0 = 0; j0 < K; j0 += kTaps) {
    const int kc = K - j0 < kTaps ? (int)(K - j0) : kTaps;
    float hr[kTaps];
#pragma unroll
    for (int jj = 0; jj < kTaps; ++jj) hr[jj] = jj < kc ? h[(j0 + jj) * M + m] : 0.f;
    // the pass's input rows t0 + j0 + r, r < kRows + kc - 1, all loaded
    // before any is used so the loads are in flight together; a row past
    // the planes is clamped to the last one (it feeds only output rows
    // >= n_out, which are not stored)
    float win[kSpan];
#pragma unroll
    for (int r = 0; r < kSpan; ++r) {
      const int64_t row = t0 + j0 + r < n_vec ? t0 + j0 + r : n_vec - 1;
      win[r] = r < kRows + kc - 1 ? to_f32(xc[row * M]) : 0.f;
    }
    // row r feeds output row i = r - jj through tap jj, so each output
    // sees its taps in order
#pragma unroll
    for (int r = 0; r < kSpan; ++r) {
#pragma unroll
      for (int jj = 0; jj < kTaps; ++jj) {
        const int i = r - jj;
        if (i >= 0 && i < kRows && jj < kc)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(hr[jj], win[r]));
      }
    }
  }

  Tout* o = out + p * out_plane + m;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (t0 + i < n_out) o[(t0 + i) * out_row] = from_f32<Tout>(acc[i]);
}

template <typename Tin, typename Tout>
void launch(const void* x, const void* h, void* out, int64_t M, int64_t K,
            int64_t n_vec, int64_t n_out, int64_t x_plane, int64_t out_plane,
            int64_t out_row, dim3 grid, cudaStream_t stream) {
  pfb_fir_kernel<Tin, Tout><<<grid, kCols, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const float*>(h),
      static_cast<Tout*>(out), M, K, n_vec, n_out, x_plane, out_plane, out_row);
}

}  // namespace

// x: planes, dtype in_dtype (0 = float32, 1 = bfloat16), plane p at
// x + p * x_plane elements, rows of M contiguous elements; h: float32
// [K, M] contiguous; out: dtype out_dtype, element (p, t, m) at
// out + p * out_plane + t * out_row + m. All on the calling thread's
// current CUDA device. Launches on `stream` without synchronising and
// returns the launch's cudaError_t.
extern "C" int pfb_fir_launch(const void* x, const void* h, void* out,
                              long long M, long long K, long long n_vec,
                              long long x_plane, long long out_plane,
                              long long out_row, int in_dtype, int out_dtype,
                              void* stream) {
  if (M < 1 || K < 1 || n_vec < K) return (int)cudaErrorInvalidValue;
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int64_t n_out = n_vec - K + 1;
  const int64_t row_tiles = (n_out + kRows - 1) / kRows;
  const int64_t col_tiles = (M + kCols - 1) / kCols;
  if (row_tiles > 0x7fffffffLL || col_tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)row_tiles, (unsigned)col_tiles, 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype * 2 + out_dtype) {
    case 0:
      launch<float, float>(x, h, out, M, K, n_vec, n_out, x_plane, out_plane, out_row, grid, s);
      break;
    case 1:
      launch<float, __nv_bfloat16>(x, h, out, M, K, n_vec, n_out, x_plane, out_plane, out_row,
                                   grid, s);
      break;
    case 2:
      launch<__nv_bfloat16, float>(x, h, out, M, K, n_vec, n_out, x_plane, out_plane, out_row,
                                   grid, s);
      break;
    default:
      launch<__nv_bfloat16, __nv_bfloat16>(x, h, out, M, K, n_vec, n_out, x_plane, out_plane,
                                           out_row, grid, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pfb_fir_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
