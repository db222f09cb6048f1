// Multi-lag fine-row detection substrate on packed IQ planes, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel lora_tpu/ops/pallas_kernels.py:_lag_rows_kernel
// (with its callers _lag_rows_call and lag_rows_pallas). For every channel
// c of packed planes x[C, 2, L] (float32 or bfloat16; element (c, p, t) at
// x + c * chan + p * plane + t), rows of sps samples (row r starts at
// r * sps, R = L / sps rows) and a sorted set of lags l >= 1:
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
// sheet's 3.35 TB/s, against about 6 GFLOP (0.09 ms at 67 TFLOP/s). Next
// come the instructions a sample: 26 FMAs, the bf16 widening and the
// shared-memory loads of each row and its partners.
//
// Design: a row-streaming kernel. A block of 8 warps owns one channel and
// a run of consecutive rows (a run may end one channel and start the
// next; the launcher sizes the runs so that the grid fills whole waves of
// resident blocks) and walks down it in steps of S = 8 rows, one output
// row a warp. Rows arrive through a shared-memory ring fed by cp.async
// kDepth = 1 step ahead; the ring holds the largest staged lag (up to 32)
// plus (kDepth + 1) * S rows, so each row is copied from device memory
// once a run, plus the 32 rows after the run that its last rows pair
// with. Rows are staged in the planes' own dtype, 256 columns at a time
// (both planes: 1 KB a row for bf16, 2 KB for float32), and widened to
// float32 in registers. A lane holds 8 columns of its warp's row and of
// each partner row, as one or two 16-byte shared loads a plane (lane j's
// vectors at columns (v * 32 + j) * 16 / itemsize: a warp reads 512
// contiguous bytes, no bank conflict), and sums its columns in registers:
// the energy and six lags' products (larger lag sets take further groups
// of six from the same staged rows). The warp then reduces the row's 13
// sums (padded to 16) with a butterfly of 16 shuffles, in a fixed order,
// and one lane stores each. A row wider than 256 columns (any sps is
// taken) is walked in column chunks, each a pass down the run; the later
// chunks add their sums to the output rows in chunk order. No atomics:
// two launches on the same input give bit-identical output.
//
// Two instantiations by load width, which the wrapper picks: 16-byte
// cp.async.cg (L1 bypassed) where the base, the plane and channel strides
// and sps * itemsize are all multiples of 16 bytes (the channelizer's
// pitched bf16 view is); else 4-byte cp.async.ca for float32 and plain
// loads for bf16 (e.g. contiguous planes of odd length). Columns past sps
// and rows past R are staged as zeros, so a partner past the last row
// gives a zero product. A lag past the staged 32 rows reads its partner
// row from device memory, in a second instantiation that only such lag
// sets launch.
//
// Resources (ptxas, CUDA 12.8, sm_90a): 256 threads; 64 registers for the
// bf16 instantiations with staged lags only, 69-80 for the others; no
// spills; no static shared memory. The ring is the dynamic shared memory,
// (32 + 2 S) rows at the gateway's lags: 49,152 bytes bf16 (four blocks an
// SM), 98,304 float32 (two). The constants (one step in flight, one row a
// warp, runs of up to 32 steps, at least three blocks an SM) were chosen
// by timing their variants at the gateway's and the US915 plan's planes
// (tune/lag_rows_variants.py); the time goes to the sums (the FMAs, the
// bf16 widening and the shared loads of 7 rows a row), not to the copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 1;             // output rows a warp sums a step
constexpr int kStep = kWarps * kRowsPerWarp;  // S: rows a step
constexpr int kDepth = 1;                   // steps whose copies are in flight while one is summed
constexpr int kRunSteps = 32;               // most steps a block's run takes before balancing
constexpr int kMinBlocks = 3;               // resident blocks an SM the registers must allow
constexpr int kCols = 256;                  // columns of a staged row chunk
constexpr int kLaneCols = kCols / 32;       // columns a lane sums: 8
constexpr int kMaxHalo = 32;                // most rows staged past a step: larger lags read memory
constexpr int kLagGroup = 6;                // lags summed in registers at once
constexpr int kSums = 16;                   // 1 + 2 * kLagGroup, padded for the butterfly
static_assert(1 + 2 * kLagGroup <= kSums, "a group's sums fit the butterfly");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of T as float32 into v[J * 16 / sizeof(T) ...] (bfloat16 ->
// float32 is exact)
template <typename T, int J>
__device__ __forceinline__ void unpack16(const uint4 u, float (&v)[kLaneCols]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[4 * J + k] = __uint_as_float(w[k]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[8 * J + 2 * k] = __uint_as_float(w[k] << 16);
      v[8 * J + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// The lane's kLaneCols columns of a staged plane row (shared memory)
template <typename T>
__device__ __forceinline__ void staged_cols(const T* row, int lane, float (&v)[kLaneCols]) {
  constexpr int kV = 16 / (int)sizeof(T);
  const uint4* p = reinterpret_cast<const uint4*>(row) + lane;
  unpack16<T, 0>(p[0], v);
  if constexpr (kLaneCols / kV == 2) unpack16<T, 1>(p[32], v);
}

// The same columns of a plane row in device memory (`row` at the chunk's
// first column, `n` columns of it in the row), zero past n or for !in
template <typename T, bool kVec>
__device__ __forceinline__ void memory_cols(const T* row, int64_t n, bool in, int lane,
                                            float (&v)[kLaneCols]) {
  constexpr int kV = 16 / (int)sizeof(T);
  if constexpr (kVec) {  // n is a whole number of vectors
    const uint4* p = reinterpret_cast<const uint4*>(row) + lane;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    unpack16<T, 0>(in && lane * kV < n ? __ldg(p) : z, v);
    if constexpr (kLaneCols / kV == 2)
      unpack16<T, 1>(in && (32 + lane) * kV < n ? __ldg(p + 32) : z, v);
  } else {
#pragma unroll
    for (int j = 0; j < kLaneCols / kV; ++j) {
      const int col = (j * 32 + lane) * kV;
#pragma unroll
      for (int k = 0; k < kV; ++k) v[j * kV + k] = in && col + k < n ? to_f32(row[col + k]) : 0.f;
    }
  }
}

// One level of the butterfly below: the lane keeps H of its 2H values
// (the upper half where its bit 2H is set) and adds its partner's.
template <int H>
__device__ __forceinline__ void butterfly_level(float (&a)[kSums], int lane) {
  const bool hi = lane & (2 * H);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float give = hi ? a[j] : a[j + H];
    const float keep = hi ? a[j + H] : a[j];
    a[j] = keep + __shfl_xor_sync(0xffffffffu, give, 2 * H);
  }
}

// Sums of a warp's 16 values, one a lane pair: after the butterfly lane i
// holds the total of value i >> 1 (both lanes of a pair the same bits).
// Every level halves the values a lane keeps and adds its partner's, so
// 8 + 4 + 2 + 1 + 1 shuffles; the order is fixed. (Each level is its own
// instantiation, so every index is a constant and the values stay in
// registers.)
__device__ __forceinline__ float warp_sums(float (&a)[kSums], int lane) {
  static_assert(kSums == 16, "four levels and a last exchange");
  butterfly_level<8>(a, lane);
  butterfly_level<4>(a, lane);
  butterfly_level<2>(a, lane);
  butterfly_level<1>(a, lane);
  return a[0] + __shfl_xor_sync(0xffffffffu, a[0], 1);
}

struct Geometry {
  int64_t C, sps, R, plane, chan;
  int n_lags, halo, cap;
  int64_t steps, units;   // steps a channel, steps of all channels
  int run;                // most steps a block takes
};

// Copy rows q0 <= q < q1 of the run (absolute row row0 + q), columns t0 ..
// t0 + kCols - 1 of both planes, into ring slots slot0 + q - q0 (mod cap);
// zeros for rows past R and columns past sps. A thread keeps one column
// (a vector or a sample) and walks the (row, plane) pairs.
template <typename T, bool kVec>
__device__ __forceinline__ void copy_rows(T* ring, const T* xc, const Geometry& g, int64_t row0,
                                          int64_t t0, int q0, int q1, int slot0) {
  constexpr int kV = kVec ? 16 / (int)sizeof(T) : 1;
  constexpr int kPer = kCols / kV;           // copies a plane row
  static_assert(kThreads % kPer == 0 || kPer % kThreads == 0, "threads tile the columns");
  constexpr int kPairs = kThreads / kPer > 0 ? kThreads / kPer : 1;  // pairs a pass
  const int n = (q1 - q0) * 2;               // (row, plane) pairs
  for (int k = threadIdx.x % kPer; k < kPer; k += kThreads) {
    const int64_t t = t0 + k * kV;
    const bool col_in = t < g.sps;           // kVec: sps is a whole number of vectors
    const T* base = xc + (row0 + q0) * g.sps + t;
    const int64_t rows_in = g.R - (row0 + q0);   // rows of the range before R
    for (int m = threadIdx.x / kPer; m < n; m += kPairs) {
      const int q = m >> 1;
      const int p = m & 1;
      int slot = slot0 + q;
      if (slot >= g.cap) slot -= g.cap;
      T* dst = ring + (slot * 2 + p) * kCols + k * kV;
      const bool in = col_in && q < rows_in;
      const T* src = base + p * g.plane + q * g.sps;
      if constexpr (kVec) {
        if (in)
          cp_async16(dst, src);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      } else if constexpr (sizeof(T) == 4) {
        if (in)
          cp_async4(dst, src);
        else
          *dst = T(0.f);
      } else {
        *dst = in ? *src : __float2bfloat16_rn(0.f);  // no cp.async of 2 bytes
      }
    }
  }
}

// The warp's output row r (ring slot `own`, chunk at column t0): its
// energy and lag products over the lane's columns, reduced across the
// warp, stored (chunk 0) or added (later chunks) by one lane each.
template <typename T, bool kVec, bool kFar>
__device__ __forceinline__ void sum_row(const T* ring, const T* xc, const int* __restrict__ lags,
                                        float* oc, const Geometry& g, int64_t r, int64_t t0,
                                        int own, int lane) {
  float are[kLaneCols], aim[kLaneCols];
  const T* orow = ring + (int64_t)own * 2 * kCols;
  staged_cols<T>(orow, lane, are);
  staged_cols<T>(orow + kCols, lane, aim);
  for (int g0 = 0; g0 < g.n_lags; g0 += kLagGroup) {
    const int ng = min(kLagGroup, g.n_lags - g0);
    float acc[kSums];
#pragma unroll
    for (int v = 0; v < kSums; ++v) acc[v] = 0.f;
    if (g0 == 0) {
#pragma unroll
      for (int e = 0; e < kLaneCols; ++e)
        acc[0] = fmaf(are[e], are[e], fmaf(aim[e], aim[e], acc[0]));
    }
#pragma unroll
    for (int k = 0; k < kLagGroup; ++k) {
      if (k < ng) {
        const int lag = __ldg(lags + g0 + k);
        float pre[kLaneCols], pim[kLaneCols];
        if (!kFar || lag <= g.halo) {
          int slot = own + lag;
          if (slot >= g.cap) slot -= g.cap;
          const T* prow = ring + (int64_t)slot * 2 * kCols;
          staged_cols<T>(prow, lane, pre);
          staged_cols<T>(prow + kCols, lane, pim);
        } else {  // a partner past the staged rows: straight from memory
          const int64_t rr = r + lag;
          const T* prow = xc + rr * g.sps + t0;
          const bool in = rr < g.R;
          memory_cols<T, kVec>(prow, g.sps - t0, in, lane, pre);
          memory_cols<T, kVec>(prow + g.plane, g.sps - t0, in, lane, pim);
        }
#pragma unroll
        for (int e = 0; e < kLaneCols; ++e) {
          acc[1 + 2 * k] = fmaf(are[e], pre[e], fmaf(aim[e], pim[e], acc[1 + 2 * k]));
          acc[2 + 2 * k] = fmaf(aim[e], pre[e], fmaf(-are[e], pim[e], acc[2 + 2 * k]));
        }
      }
    }
    const float total = warp_sums(acc, lane);
    const int v = lane >> 1;   // the value this lane pair holds
    if (!(lane & 1) && v < 1 + 2 * ng && (v > 0 || g0 == 0)) {
      float* o = oc + (v == 0 ? 0 : 2 * (int64_t)g0 + v) * g.R + r;
      *o = t0 == 0 ? total : *o + total;
    }
  }
}

template <typename T, bool kVec, bool kFar>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lag_rows_kernel(const T* __restrict__ x, const int* __restrict__ lags, float* __restrict__ out,
                Geometry g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n_out = 1 + 2 * (int64_t)g.n_lags;
  const int64_t u_first = (int64_t)blockIdx.x * g.run;
  const int64_t u_end = u_first + g.run < g.units ? u_first + g.run : g.units;
  for (int64_t u = u_first; u < u_end;) {
    // the part of the run in one channel: steps s_first .. s_first + n_steps - 1
    const int64_t c = u / g.steps;
    const int64_t s_first = u - c * g.steps;
    const int n_steps = (int)(g.steps - s_first < u_end - u ? g.steps - s_first : u_end - u);
    u += n_steps;
    const T* xc = x + c * g.chan;
    float* oc = out + c * n_out * g.R;
    const int64_t row0 = s_first * kStep;
    for (int64_t t0 = 0; t0 < g.sps; t0 += kCols) {
      // prologue: the halo and step 0, then steps 1 .. kDepth - 1, a copy group each
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        if (d < n_steps) {
          const int q0 = d == 0 ? 0 : g.halo + d * kStep;
          copy_rows<T, kVec>(ring, xc, g, row0, t0, q0, g.halo + (d + 1) * kStep, q0);
        }
        cp_async_commit();
      }
      int read_slot = 0;                          // ring slot of row s * S
      int fill_slot = g.halo + kDepth * kStep;    // ring slot of row halo + (s + kDepth) * S
      for (int s = 0; s < n_steps; ++s) {
        // step s's rows have landed (each thread's own copies, then
        // everyone's), and every warp is done with step s - 1, whose rows
        // the next copies overwrite
        cp_async_wait<kDepth - 1>();
        __syncthreads();
        if (s + kDepth < n_steps)
          copy_rows<T, kVec>(ring, xc, g, row0, t0, g.halo + (s + kDepth) * kStep,
                             g.halo + (s + kDepth + 1) * kStep, fill_slot);
        cp_async_commit();
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int w = warp + i * kWarps;
          const int64_t r = row0 + (int64_t)s * kStep + w;
          int own = read_slot + w;
          if (own >= g.cap) own -= g.cap;
          if (r < g.R) sum_row<T, kVec, kFar>(ring, xc, lags, oc, g, r, t0, own, lane);
        }
        read_slot += kStep;
        if (read_slot >= g.cap) read_slot -= g.cap;
        fill_slot += kStep;
        if (fill_slot >= g.cap) fill_slot -= g.cap;
      }
      __syncthreads();  // the ring is free for the next chunk or channel
    }
  }
}

template <typename T, bool kVec, bool kFar>
int launch(const void* x, const int* lags, float* out, Geometry g, cudaStream_t stream) {
  auto kern = lag_rows_kernel<T, kVec, kFar>;
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const int64_t smem = (int64_t)g.cap * 2 * kCols * (int64_t)sizeof(T);
  if (smem > max_smem) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // runs: at most kRunSteps steps, as equal as whole waves of resident
  // blocks allow; a run may cross from one channel into the next
  const int64_t slots = (int64_t)per_sm * sms;
  const int64_t waves = (g.units + slots * kRunSteps - 1) / (slots * kRunSteps);
  const int64_t run = (g.units + slots * waves - 1) / (slots * waves);
  const int64_t blocks = (g.units + run - 1) / run;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  g.run = (int)run;
  kern<<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(static_cast<const T*>(x), lags, out,
                                                              g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(const void* x, const int* lags, float* out, const Geometry& g, int max_lag,
                 int vec, cudaStream_t stream) {
  constexpr int kV = 16 / (int)sizeof(T);
  const bool far = max_lag > kMaxHalo;
  if (vec == 1)
    return far ? launch<T, false, true>(x, lags, out, g, stream)
               : launch<T, false, false>(x, lags, out, g, stream);
  // the vector width: every 16-byte chunk of every row must be aligned
  if (vec != kV || reinterpret_cast<uintptr_t>(x) % 16 || g.plane % kV ||
      (g.C > 1 && g.chan % kV) || g.sps % kV)
    return (int)cudaErrorInvalidValue;
  return far ? launch<T, true, true>(x, lags, out, g, stream)
             : launch<T, true, false>(x, lags, out, g, stream);
}

}  // namespace

// x: planes, dtype 0 = float32 or 1 = bfloat16, element (c, p, t) at x +
// c * chan + p * plane + t (each plane's L samples contiguous); lags:
// n_lags sorted, unique int32 lags >= 1 in device memory, the largest
// max_lag; out: float32 [C, 1 + 2 * n_lags, L / sps], contiguous. vec:
// samples a copy moves, 1 (scalar) or 16 bytes' worth (4 float32, 8
// bfloat16), which needs x, the plane and channel strides and sps to be
// whole 16-byte vectors (else cudaErrorInvalidValue). All on the calling
// thread's current CUDA device. Launches on `stream` without
// synchronising and returns the launch's cudaError_t.
extern "C" int lag_rows_launch(const void* x, const void* lags, void* out, long long C,
                               long long L, long long sps, long long plane, long long chan,
                               int n_lags, int max_lag, int dtype, int vec, void* stream) {
  if (C < 1 || sps < 1 || L < sps || n_lags < 1 || max_lag < 1)
    return (int)cudaErrorInvalidValue;
  Geometry g{};
  g.C = C;
  g.sps = sps;
  g.R = L / sps;
  g.plane = plane;
  g.chan = chan;
  g.n_lags = n_lags;
  g.halo = max_lag < kMaxHalo ? max_lag : kMaxHalo;
  g.cap = g.halo + (kDepth + 1) * kStep;
  g.steps = (g.R + kStep - 1) / kStep;
  g.units = g.steps * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lg = static_cast<const int*>(lags);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch_width<float>(x, lg, o, g, max_lag, vec, s);
  if (dtype == 1) return launch_width<__nv_bfloat16>(x, lg, o, g, max_lag, vec, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* lag_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
