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
// order from 0.f, one multiply and one add each (no fused multiply-add),
// so the result is bit-equal to the plain version pfb_fir_planes; the
// output is float32 or bfloat16 (rounded to nearest even once). The output
// element (p, t, m) is written at out + p * out_plane + t * out_row + m:
// the wrapper picks the [n_out, 2, M] layout, whose rows [fr | fi] the DFT
// product reads without a copy.
//
// What bounds it: device-memory bytes. It must read the planes once and
// write the output once: at the gateway shape (M = 256, n_vec = 450,560,
// K = 10, float32 in, bfloat16 out) 922.7 MB in and 461.4 MB out, 0.413 ms
// at the H100 SXM data-sheet 3.35 TB/s; its 2 flops a tap and output (4.6
// GFLOP) take a third of that on the float32 cores.
//
// Design: a streaming kernel. A block owns a plane (both, in a narrow
// tile), a tile of branches and a run of output rows (the launcher sizes
// the runs so the grid fills whole waves of resident blocks). A thread
// owns V adjacent branches: V = 4 float32 or 8 bfloat16, so each copy,
// shared-memory read and store moves 16 bytes of input, where the planes'
// base, their plane stride, M and the taps' base allow it (the wrapper
// decides and passes V); otherwise V = 1, the same kernel's scalar
// instantiation. The block's threads are Tc threads across the tile times
// G row groups. Input rows go
// through a ring of shared-memory rows in steps of S = G * kR rows (kR =
// 32 / V output rows a thread, so its 32 float32 sums stay in registers):
// the K - 1 halo rows plus kDepth steps ahead are copied with cp.async
// (16-byte .cg, L1 bypassed; 4-byte .ca for scalar float32; plain loads for
// scalar bfloat16, which has no cp.async size), so while step s is summed
// the copies of steps s + 1 and s + 2 are in flight. A row stays in the
// ring until the last step that reads it, so each input element is read
// from device memory once, plus the K - 1 rows a run shares with the next
// (under 4 % of the reads at runs of 256 rows and more). A step sums its
// rows in tap passes of 8, 4, 2 and 1 taps (the binary digits of the
// remaining K: K = 10 is one pass of 8 and one of 2), each a fully
// unrolled loop with no idle taps: a pass holds its taps for the thread's
// branches in registers and reads each of its kR + P - 1 rows once from
// shared memory into a V-wide register row that feeds every output row it
// touches, in tap order.
//
// The tile: the chunks = ceil(M / V) of a row. A wide tile (chunks > 16:
// pfb_fir_kernel) has Tc = the fewest of 32, 64 or 128 threads across
// that cover them, G = 128 / Tc row groups, a block a plane, a warp on one
// row group. A narrow tile (chunks <= 16: pfb_fir_narrow_kernel, the
// same ring and tap passes) has Tc = twice the fewest power of two (2 to
// 32) that cover them, both planes in one block (plane 0 on the first half
// of the tile's threads), G = 128 / Tc row groups, so that a warp holds
// 32 / Tc row groups and every lane sums live branches: at M = 8 float32
// (V = 4) Tc = 4, G = 32, S = 256 rows a step. The narrow kernel repeats
// the wide one's loop rather than sharing its body: one body for both
// tiles gave the wide instantiations another instruction schedule, 1-2 %
// slower on an H100. Two things hold a narrow tile back, and the narrow
// kernel answers each:
// - Its stores. A thread's kR output rows are its own, so a warp's store
//   would span 32 / Tc rows kR apart, and on an H100 such stores took most
//   of the launch. So a step's outputs go through a shared-memory stage
//   and leave it by consecutive chunks: a warp stores consecutive output
//   rows, each a whole [fr | fi] row.
// - Shared-memory banks. Its row groups start kR ring rows apart, and
//   with a ring row narrower than 128 bytes that is a multiple of 128
//   bytes, so the lanes of one wavefront would read one bank quad (4-way
//   at M = 4, 32-way at M = 1). So below 32 threads across, the ring and
//   the stage leave one row of padding after every kR rows (row r lies at
//   r + r / kR): a row group starts kR + 1 rows after its neighbour, and
//   the groups of a wavefront fall on distinct banks.
//
// Resources (ptxas, CUDA 12.8, sm_90a): the wide kernel, float32 in, 118
// registers (V = 4) and 125 (V = 1); bfloat16 in, 131-136 (V = 8) and 96
// (V = 1); no spills; no static shared memory. The ring is the dynamic
// shared memory, (K - 1 + 3 S) rows of Tc * V elements: at the gateway
// shape 57 rows of 1 KB (58,368 bytes, three blocks an SM), at the
// wideband shape (M = 1024) 33 rows of 2 KB (67,584 bytes, three blocks an
// SM). The narrow kernel's adds its padding rows and the stage (S rows of
// Tc * V outputs, and their padding): at M = 8, K = 13 float32 780 + 97
// rows of 64 bytes and 256 + 31 stage rows (74,496 bytes, three blocks an
// SM). A K whose ring does not fit a block's shared memory narrows a wide
// tile (down to Tc = 32) and takes row groups from a narrow one (G halved,
// down to 1, the block's threads with it); past that the launch is refused
// with cudaErrorInvalidValue. The wide tile takes K <= 359 taps a branch
// for V = 4 float32, 407 for V = 8 bfloat16, 1,433 for scalar float32,
// 3,249 for scalar bfloat16. The narrow tile takes at least as many at
// every M (its rows are no wider and its S * Tc the same): for float32
// planes and output up to 3,199 taps at M = 8, 6,427 at M = 4, 423 at M =
// 64 and 28,050 at M = 1 (scalar). Any M >= 1, n_vec >= K and plane stride
// is taken otherwise: ragged branch tiles mask their last threads, ragged
// runs their last rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsLog2 = 7;
constexpr int kThreads = 1 << kThreadsLog2;   // threads a block (fewer: a narrow tile's large K)
constexpr int kWarpLog2 = 5;    // a tile narrower than this many threads is narrow
constexpr int kAcc = 32;        // float32 sums a thread: kR output rows x V branches
constexpr int kDepth = 2;       // steps whose copies are in flight while one is summed
constexpr int kRunSteps = 32;   // most steps a block's run takes before balancing
constexpr int kMinBlocks = 3;   // resident blocks an SM the registers must allow
constexpr int kPadRows = 1;     // a narrow ring's padding rows after every kR rows

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

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

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

// one thread's V elements of a row, device memory -> shared memory
template <typename Tin, int V>
__device__ __forceinline__ void copy_chunk(Tin* dst, const Tin* src) {
  if constexpr (V * sizeof(Tin) == 16) {
    cp_async16(dst, src);
  } else if constexpr (sizeof(Tin) == 4) {
    cp_async4(dst, src);
  } else {
    *dst = *src;  // a lone bfloat16: no cp.async of 2 bytes
  }
}

// V elements of a ring row, as float32 (bfloat16 -> float32 is exact)
template <typename Tin, int V>
__device__ __forceinline__ void load_row(const Tin* p, float (&x)[V]) {
  if constexpr (V == 1) {
    x[0] = to_f32(*p);
  } else if constexpr (sizeof(Tin) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = __uint_as_float(w[k] << 16);
      x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// V outputs of a row, each rounded once
template <typename Tout, int V>
__device__ __forceinline__ void store_row(Tout* p, const float (&a)[V]) {
  if constexpr (V == 1) {
    *p = from_f32<Tout>(a[0]);
  } else if constexpr (sizeof(Tout) == 4) {
#pragma unroll
    for (int k = 0; k < V; k += 4)
      *reinterpret_cast<float4*>(p + k) = make_float4(a[k], a[k + 1], a[k + 2], a[k + 3]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(a[0], a[1]), bf16_pair(a[2], a[3]));
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(bf16_pair(a[0], a[1]), bf16_pair(a[2], a[3]),
                                              bf16_pair(a[4], a[5]), bf16_pair(a[6], a[7]));
  }
}

// Where ring slot `slot` lies, in ring rows: a narrow ring (and its
// output stage) leaves `pad` rows of padding after every kR slots
template <int kR>
__device__ __forceinline__ int ring_row(int slot, int pad) {
  return slot + pad * (int)((unsigned)slot / kR);
}

// rows that n slots span with `pad` rows of padding after every kR
__host__ __device__ __forceinline__ int64_t padded_rows(int64_t n, int kR, int pad) {
  return n + pad * ((n - 1) / kR);
}

// a narrow tile's padding rows: kPadRows where a warp holds several row
// groups (Tc < 32), none where a warp is one row group
__host__ __device__ __forceinline__ int pad_rows(int tc_log2) {
  return tc_log2 < kWarpLog2 ? kPadRows : 0;
}

// V elements, shared memory -> device memory, in the widest aligned words
template <typename T, int V>
__device__ __forceinline__ void move_chunk(T* dst, const T* src) {
  constexpr int kBytes = V * (int)sizeof(T);
  if constexpr (kBytes == 32) {
    reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(src)[0];
    reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(src)[1];
  } else if constexpr (kBytes == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else {
    *dst = *src;
  }
}

// Taps j0 .. j0 + P - 1 of one step: ring slots slot, slot + 1, ... (mod
// cap) of the thread's column `col` hold the rows t0 + j0 + r of its kR
// output rows t0 + i; row r feeds output row i = r - jj through tap jj, so
// each output sees its taps in order.
template <typename Tin, int V, int kR, int P>
__device__ __forceinline__ void tap_pass(float (&acc)[kR][V], const float* __restrict__ h,
                                         int64_t M, int64_t m, bool live, int j0,
                                         const Tin* col, int W, int cap, int slot) {
  float hr[P][V];
#pragma unroll
  for (int jj = 0; jj < P; ++jj) {
    const float* hj = h + (j0 + jj) * M + m;
    if constexpr (V == 1) {
      hr[jj][0] = live ? *hj : 0.f;
    } else {
#pragma unroll
      for (int k = 0; k < V; k += 4) {
        const float4 f = live ? *reinterpret_cast<const float4*>(hj + k)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        hr[jj][k] = f.x;
        hr[jj][k + 1] = f.y;
        hr[jj][k + 2] = f.z;
        hr[jj][k + 3] = f.w;
      }
    }
  }
  const Tin* rp = col + slot * W;
  const Tin* end = col + cap * W;
#pragma unroll
  for (int r = 0; r < kR + P - 1; ++r) {
    float xv[V];
    load_row<Tin, V>(rp, xv);
#pragma unroll
    for (int jj = 0; jj < P; ++jj) {
      const int i = r - jj;
      if (i >= 0 && i < kR) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[i][v] = __fadd_rn(acc[i][v], __fmul_rn(hr[jj][v], xv[v]));
      }
    }
    rp += W;
    if (rp == end) rp = col;
  }
}

// tap_pass on a narrow ring, whose slot `slot` lies at ring_row(slot, pad)
template <typename Tin, int V, int kR, int P>
__device__ __forceinline__ void tap_pass_narrow(float (&acc)[kR][V], const float* __restrict__ h,
                                                int64_t M, int64_t m, bool live, int j0,
                                                const Tin* col, int W, int cap, int slot,
                                                int pad) {
  float hr[P][V];
#pragma unroll
  for (int jj = 0; jj < P; ++jj) {
    const float* hj = h + (j0 + jj) * M + m;
    if constexpr (V == 1) {
      hr[jj][0] = live ? *hj : 0.f;
    } else {
#pragma unroll
      for (int k = 0; k < V; k += 4) {
        const float4 f = live ? *reinterpret_cast<const float4*>(hj + k)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        hr[jj][k] = f.x;
        hr[jj][k + 1] = f.y;
        hr[jj][k + 2] = f.z;
        hr[jj][k + 3] = f.w;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kR + P - 1; ++r) {
    float xv[V];
    load_row<Tin, V>(col + ring_row<kR>(slot, pad) * W, xv);
    if (++slot == cap) slot = 0;
#pragma unroll
    for (int jj = 0; jj < P; ++jj) {
      const int i = r - jj;
      if (i >= 0 && i < kR) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[i][v] = __fadd_rn(acc[i][v], __fmul_rn(hr[jj][v], xv[v]));
      }
    }
  }
}

template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pfb_fir_kernel(const Tin* __restrict__ x, const float* __restrict__ h,
               Tout* __restrict__ out, int64_t M, int K, int64_t n_vec, int64_t n_out,
               int64_t x_plane, int64_t out_plane, int64_t out_row, int tc_log2, int cap,
               int run_steps) {
  constexpr int kR = kAcc / V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = kThreads >> tc_log2;       // row groups
  const int S = G * kR;                    // output rows a step, new input rows a step
  const int W = V << tc_log2;              // elements a ring row
  const int g = threadIdx.x >> tc_log2;
  const int c = threadIdx.x & ((1 << tc_log2) - 1);
  const int p = blockIdx.z;
  const int64_t m = (((int64_t)blockIdx.y << tc_log2) + c) * V;   // the thread's first branch
  const bool live = m < M;
  const int64_t t_base = (int64_t)blockIdx.x * run_steps * S;
  const int64_t left = (n_out - t_base + S - 1) / S;
  const int n_steps = left < run_steps ? (int)left : run_steps;
  const Tin* xp = x + p * x_plane + (live ? m : 0);
  Tin* col = reinterpret_cast<Tin*>(smem_raw) + c * V;   // the thread's column of the ring

  // copy input rows t_base + r, r0 <= r < r1, into ring slots slot0 + r - r0
  // (mod cap); the thread copies its own column of rows g, g + G, ...
  auto copy_rows = [&](int r0, int r1, int slot0) {
    for (int r = r0 + g; r < r1; r += G) {
      int slot = slot0 + r - r0;
      if (slot >= cap) slot -= cap;
      const int64_t row = t_base + r;
      if (live && row < n_vec) copy_chunk<Tin, V>(col + slot * W, xp + row * M);
    }
  };

  // prologue: the halo and step 0, then steps 1 .. kDepth - 1, a copy group each
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    if (d < n_steps) copy_rows(d == 0 ? 0 : K - 1 + d * S, K - 1 + (d + 1) * S,
                               d == 0 ? 0 : K - 1 + d * S);
    cp_async_commit();
  }

  int read_slot = 0;                        // ring slot of row s * S
  int fill_slot = K - 1 + kDepth * S;       // ring slot of row K - 1 + (s + kDepth) * S
  for (int s = 0; s < n_steps; ++s) {
    // step s's rows have landed (each thread's own copies, then everyone's),
    // and every thread is done with step s - 1, whose first S rows the next
    // copies overwrite
    cp_async_wait<kDepth - 1>();
    __syncthreads();
    if (s + kDepth < n_steps)
      copy_rows(K - 1 + (s + kDepth) * S, K - 1 + (s + kDepth + 1) * S, fill_slot);
    cp_async_commit();

    float acc[kR][V];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[i][v] = 0.f;
    // the group's first output row s * S + g * kR; its tap j0 row is j0 later
    const int first = read_slot + g * kR;
    for (int j0 = 0; j0 < K;) {
      int slot = first + j0;
      if (slot >= cap) slot -= cap;
      const int rem = K - j0;
      if (rem >= 8) {
        tap_pass<Tin, V, kR, 8>(acc, h, M, m, live, j0, col, W, cap, slot);
        j0 += 8;
      } else if (rem >= 4) {
        tap_pass<Tin, V, kR, 4>(acc, h, M, m, live, j0, col, W, cap, slot);
        j0 += 4;
      } else if (rem >= 2) {
        tap_pass<Tin, V, kR, 2>(acc, h, M, m, live, j0, col, W, cap, slot);
        j0 += 2;
      } else {
        tap_pass<Tin, V, kR, 1>(acc, h, M, m, live, j0, col, W, cap, slot);
        j0 += 1;
      }
    }
    const int64_t t0 = t_base + (int64_t)s * S + g * kR;
    if (live) {
      Tout* o = out + p * out_plane + m;
#pragma unroll
      for (int i = 0; i < kR; ++i)
        if (t0 + i < n_out) store_row<Tout, V>(o + (t0 + i) * out_row, acc[i]);
    }
    read_slot += S;
    if (read_slot >= cap) read_slot -= cap;
    fill_slot += S;
    if (fill_slot >= cap) fill_slot -= cap;
  }
}

// The narrow tile (see Design): both planes a block, a padded ring, the
// outputs staged in shared memory
template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pfb_fir_narrow_kernel(const Tin* __restrict__ x, const float* __restrict__ h,
                      Tout* __restrict__ out, int64_t M, int K, int64_t n_vec, int64_t n_out,
                      int64_t x_plane, int64_t out_plane, int64_t out_row, int tc_log2,
                      int cap, int run_steps) {
  constexpr int kR = kAcc / V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // row groups: the block may hold fewer than kThreads threads
  const int G = (int)blockDim.x >> tc_log2;
  const int S = G * kR;                    // output rows a step, new input rows a step
  const int W = V << tc_log2;              // elements a ring row
  const int pad = pad_rows(tc_log2);
  const int g = threadIdx.x >> tc_log2;
  const int c = threadIdx.x & ((1 << tc_log2) - 1);
  // both planes: plane 0 on the first half of the tile's threads
  const int half_log2 = tc_log2 - 1;
  const int p = c >> half_log2;
  const int64_t m = (int64_t)(c & ((1 << half_log2) - 1)) * V;   // the thread's first branch
  const bool live = m < M;
  const int64_t t_base = (int64_t)blockIdx.x * run_steps * S;
  const int64_t left = (n_out - t_base + S - 1) / S;
  const int n_steps = left < run_steps ? (int)left : run_steps;
  const Tin* xp = x + p * x_plane + (live ? m : 0);
  Tin* col = reinterpret_cast<Tin*>(smem_raw) + c * V;   // the thread's column of the ring
  // the output stage after the ring, rows padded as the ring's
  Tout* stage = reinterpret_cast<Tout*>(
      smem_raw + ((padded_rows(cap, kR, pad) * W * (int64_t)sizeof(Tin) + 15) & ~(int64_t)15));

  // copy input rows t_base + r, r0 <= r < r1, into ring slots slot0 + r - r0
  // (mod cap); the thread copies its own column of rows g, g + G, ...
  auto copy_rows = [&](int r0, int r1, int slot0) {
    for (int r = r0 + g; r < r1; r += G) {
      int slot = slot0 + r - r0;
      if (slot >= cap) slot -= cap;
      const int64_t row = t_base + r;
      if (live && row < n_vec)
        copy_chunk<Tin, V>(col + ring_row<kR>(slot, pad) * W, xp + row * M);
    }
  };

  // prologue: the halo and step 0, then steps 1 .. kDepth - 1, a copy group each
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    if (d < n_steps) copy_rows(d == 0 ? 0 : K - 1 + d * S, K - 1 + (d + 1) * S,
                               d == 0 ? 0 : K - 1 + d * S);
    cp_async_commit();
  }

  int read_slot = 0;                        // ring slot of row s * S
  int fill_slot = K - 1 + kDepth * S;       // ring slot of row K - 1 + (s + kDepth) * S
  for (int s = 0; s < n_steps; ++s) {
    // step s's rows have landed (each thread's own copies, then everyone's),
    // and every thread is done with step s - 1, whose first S rows the next
    // copies overwrite
    cp_async_wait<kDepth - 1>();
    __syncthreads();
    if (s + kDepth < n_steps)
      copy_rows(K - 1 + (s + kDepth) * S, K - 1 + (s + kDepth + 1) * S, fill_slot);
    cp_async_commit();

    float acc[kR][V];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[i][v] = 0.f;
    // the group's first output row s * S + g * kR; its tap j0 row is j0 later
    const int first = read_slot + g * kR;
    for (int j0 = 0; j0 < K;) {
      int slot = first + j0;
      if (slot >= cap) slot -= cap;
      const int rem = K - j0;
      if (rem >= 8) {
        tap_pass_narrow<Tin, V, kR, 8>(acc, h, M, m, live, j0, col, W, cap, slot, pad);
        j0 += 8;
      } else if (rem >= 4) {
        tap_pass_narrow<Tin, V, kR, 4>(acc, h, M, m, live, j0, col, W, cap, slot, pad);
        j0 += 4;
      } else if (rem >= 2) {
        tap_pass_narrow<Tin, V, kR, 2>(acc, h, M, m, live, j0, col, W, cap, slot, pad);
        j0 += 2;
      } else {
        tap_pass_narrow<Tin, V, kR, 1>(acc, h, M, m, live, j0, col, W, cap, slot, pad);
        j0 += 1;
      }
    }
    // the step's outputs go through the stage, so that a warp's stores
    // cover consecutive output rows [fr | fi]; the next step's first
    // barrier keeps the stage until every thread has stored from it
#pragma unroll
    for (int i = 0; i < kR; ++i)
      store_row<Tout, V>(stage + ring_row<kR>(g * kR + i, pad) * W + c * V, acc[i]);
    __syncthreads();
    const int64_t t_step = t_base + (int64_t)s * S;
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      // chunk q of the stage: row q / Tc, column q % Tc
      const int q = threadIdx.x + k * (int)blockDim.x;
      const int r = q >> tc_log2;
      const int cq = q & ((1 << tc_log2) - 1);
      const int64_t mq = (int64_t)(cq & ((1 << half_log2) - 1)) * V;
      if (mq < M && t_step + r < n_out)
        move_chunk<Tout, V>(out + (cq >> half_log2) * out_plane + (t_step + r) * out_row + mq,
                            stage + ring_row<kR>(r, pad) * W + cq * V);
    }
    read_slot += S;
    if (read_slot >= cap) read_slot -= cap;
    fill_slot += S;
    if (fill_slot >= cap) fill_slot -= cap;
  }
}

struct Geometry {
  int64_t M, K, n_vec, n_out, x_plane, out_plane, out_row;
};

// One call's launch geometry: Tc = 1 << tc_log2 threads across, G = 1 <<
// g_log2 row groups, S rows a step, a ring of `cap` slots in ring_rows rows
// (smem bytes), per_sm resident blocks an SM, runs x col_tiles x 2 blocks
// of `run` steps each
struct Plan {
  int tc_log2, g_log2, per_sm;
  int64_t S, cap, ring_rows, smem, col_tiles, run, runs;
};

// Plans the launch and, unless `dry`, launches
template <typename Tin, typename Tout, int V>
int launch(const void* x, const void* h, void* out, const Geometry& q, cudaStream_t stream,
           Plan& pl, bool dry) {
  constexpr int kR = kAcc / V;
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  // the tile. Wide: the fewest threads across (32 .. 128) that cover the
  // chunks = ceil(M / V) of a row, a plane a block. Narrow (chunks <= 16):
  // twice the fewest (2 .. 32) that cover them, both planes a block. While
  // the ring does not fit, a wide tile narrows (down to a warp) and a
  // narrow one drops row groups (down to one)
  const int64_t chunks = (q.M + V - 1) / V;
  int cover_log2 = 0;
  while ((1LL << cover_log2) < chunks) ++cover_log2;
  const bool narrow = cover_log2 < kWarpLog2;
  int tc_log2 = narrow ? cover_log2 + 1
                       : (cover_log2 < kThreadsLog2 ? cover_log2 : kThreadsLog2);
  int g_log2 = kThreadsLog2 - tc_log2;
  int64_t S = 0, cap = 0, rows = 0, smem = 0;
  for (;;) {
    S = (int64_t)kR << g_log2;
    cap = q.K - 1 + (kDepth + 1) * S;
    const int pad = narrow ? pad_rows(tc_log2) : 0;
    rows = padded_rows(cap, kR, pad);
    smem = rows * ((int64_t)V << tc_log2) * (int64_t)sizeof(Tin);
    if (narrow)   // the output stage after the ring
      smem = ((smem + 15) & ~(int64_t)15) +
             padded_rows(S, kR, pad) * ((int64_t)V << tc_log2) * (int64_t)sizeof(Tout);
    if (smem <= max_smem) break;
    if (narrow && g_log2 > 0) {
      --g_log2;
    } else if (!narrow && tc_log2 > kWarpLog2) {
      --tc_log2;
      ++g_log2;
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  auto kern = narrow ? pfb_fir_narrow_kernel<Tin, Tout, V> : pfb_fir_kernel<Tin, Tout, V>;
  const int threads = 1 << (tc_log2 + g_log2);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // runs: at most kRunSteps steps, as equal as whole waves of resident
  // blocks allow
  const int64_t col_tiles = narrow ? 1 : (chunks + (1LL << tc_log2) - 1) >> tc_log2;
  const int64_t planes = narrow ? 1 : 2;   // blocks a column tile and run
  const int64_t steps = (q.n_out + S - 1) / S;
  const int64_t units = steps * col_tiles * planes;
  const int64_t slots = (int64_t)per_sm * sms;
  const int64_t waves = (units + slots * kRunSteps - 1) / (slots * kRunSteps);
  const int64_t run = (units + slots * waves - 1) / (slots * waves);
  const int64_t runs = (steps + run - 1) / run;
  if (runs > 0x7fffffffLL || col_tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  pl = Plan{tc_log2, g_log2, per_sm, S, cap, rows, smem, col_tiles, run, runs};
  if (dry) return 0;
  const dim3 grid((unsigned)runs, (unsigned)col_tiles, (unsigned)planes);
  kern<<<grid, threads, (size_t)smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const float*>(h), static_cast<Tout*>(out), q.M,
      (int)q.K, q.n_vec, q.n_out, q.x_plane, q.out_plane, q.out_row, tc_log2, (int)cap, (int)run);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int launch_width(const void* x, const void* h, void* out, const Geometry& q, int vec,
                 cudaStream_t stream, Plan& pl, bool dry) {
  constexpr int kV = 16 / (int)sizeof(Tin);
  if (vec == 1) return launch<Tin, Tout, 1>(x, h, out, q, stream, pl, dry);
  // the vector width: every 16-byte chunk of input and of taps, and every
  // V-wide store, must be aligned
  const int64_t store = kV * (int64_t)sizeof(Tout) < 16 ? kV * (int64_t)sizeof(Tout) : 16;
  if (vec != kV || reinterpret_cast<uintptr_t>(x) % 16 || q.x_plane % kV || q.M % kV ||
      reinterpret_cast<uintptr_t>(h) % 16 || reinterpret_cast<uintptr_t>(out) % store ||
      q.out_plane % kV || q.out_row % kV)
    return (int)cudaErrorInvalidValue;
  return launch<Tin, Tout, kV>(x, h, out, q, stream, pl, dry);
}

int dispatch(const void* x, const void* h, void* out, long long M, long long K, long long n_vec,
             long long x_plane, long long out_plane, long long out_row, int in_dtype,
             int out_dtype, int vec, cudaStream_t s, Plan& pl, bool dry) {
  if (M < 1 || K < 1 || n_vec < K || K > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const Geometry q{M, K, n_vec, n_vec - K + 1, x_plane, out_plane, out_row};
  switch (in_dtype * 2 + out_dtype) {
    case 0:
      return launch_width<float, float>(x, h, out, q, vec, s, pl, dry);
    case 1:
      return launch_width<float, __nv_bfloat16>(x, h, out, q, vec, s, pl, dry);
    case 2:
      return launch_width<__nv_bfloat16, float>(x, h, out, q, vec, s, pl, dry);
    default:
      return launch_width<__nv_bfloat16, __nv_bfloat16>(x, h, out, q, vec, s, pl, dry);
  }
}

}  // namespace

// x: planes, dtype in_dtype (0 = float32, 1 = bfloat16), plane p at
// x + p * x_plane elements, rows of M contiguous elements; h: float32
// [K, M] contiguous; out: dtype out_dtype, element (p, t, m) at
// out + p * out_plane + t * out_row + m. vec: branches a thread owns, 1
// (scalar) or 16 bytes of input (4 float32, 8 bfloat16), which needs x,
// h and the plane stride 16-byte aligned, M a multiple of vec and out, the
// output plane and row strides aligned for vec-wide stores (else
// cudaErrorInvalidValue). All on the calling thread's current CUDA device.
// Launches on `stream` without synchronising and returns the launch's
// cudaError_t.
extern "C" int pfb_fir_launch(const void* x, const void* h, void* out,
                              long long M, long long K, long long n_vec,
                              long long x_plane, long long out_plane,
                              long long out_row, int in_dtype, int out_dtype, int vec,
                              void* stream) {
  Plan pl;
  return dispatch(x, h, out, M, K, n_vec, x_plane, out_plane, out_row, in_dtype, out_dtype, vec,
                  static_cast<cudaStream_t>(stream), pl, false);
}

// The geometry pfb_fir_launch would launch with the same arguments, into
// geom[10]: Tc, G, S, ring slots, ring rows, ring bytes, resident blocks an
// SM, runs, column tiles, steps a run. Launches nothing; returns the
// cudaError_t the launch would return before launching.
extern "C" int pfb_fir_geometry(const void* x, const void* h, void* out,
                                long long M, long long K, long long n_vec,
                                long long x_plane, long long out_plane,
                                long long out_row, int in_dtype, int out_dtype, int vec,
                                long long* geom) {
  Plan pl;
  const int rc = dispatch(x, h, out, M, K, n_vec, x_plane, out_plane, out_row, in_dtype,
                          out_dtype, vec, nullptr, pl, true);
  if (rc == 0) {
    const long long g[10] = {1LL << pl.tc_log2, 1LL << pl.g_log2, pl.S, pl.cap, pl.ring_rows,
                             pl.smem, pl.per_sm, pl.runs, pl.col_tiles, pl.run};
    for (int i = 0; i < 10; ++i) geom[i] = g[i];
  }
  return rc;
}

extern "C" const char* pfb_fir_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
