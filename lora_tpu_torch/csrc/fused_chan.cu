// Mix + decimating FIR + output ramp over a LoRaWAN channel plan, for
// Hopper (sm_90a): the mixer applied to the staged input per channel, then
// the real taps.
//
// Replaces the TPU kernel lora_tpu/ops/pallas_kernels.py:_fused_chan_kernel
// (with its callers _fused_chan_call and fused_channelize_pallas), which
// computes the same function in a folded form (the mixer folded into
// complex taps g2, then one contraction). For the packed wideband planes
// x[2, L] float32 (plane p starts at x + p * x_plane, its samples
// contiguous), the real taps h[K*D] (zero-padded past n_taps), the phase
// table phi[C, 2, D] = exp(-2 pi i frac(a_c d)) and the output-ramp factors
// o[C, nb], i[C, tile] (o[c, b] * i[c, l] = exp(-2 pi i a_c D (b*tile + l)),
// a_c = f_c / fs), every channel c < C and output n < n_out = (L - n_taps)/D
// + 1 gets
//
//   y_c[n] = sum_{j<K, d<D} h[j*D + d] * x[(n + j)*D + d] * exp(-2 pi i a_c ((n + j)*D + d))
//
// (samples at index >= L read as zero), out[c, 0, n] = Re, out[c, 1, n] =
// Im, [C, 2, n_out] contiguous float32. A block owns kT outputs from n0 on;
// with q = n - n0 + j the phasor splits as
//
//   exp(-2 pi i a_c ((n0 + q)*D + d)) = R_c[n0] * rho_c[q] * phi_c[d]
//   R_c[n0] = o[c, n0 / tile] * i[c, n0 % tile],   rho_c[q] = i[c, q]
//
// so the kernel needs q < kT + K - 1 <= tile (the launcher refuses a larger
// K). Every phase is reduced in float64 on the host; the device forms only
// products of float32 phasors.
//
// What bounds the function: float32 operations. It needs at least 6D + 4
// n_taps flops a channel and output (chip_smoke.fused_min_ops): at the US915
// plan shape (C = 23, D = 32, 309 taps, K = 10, n_out = 450,551) 14.8 GFLOP,
// 0.22 ms at the H100 SXM data-sheet 67 TFLOP/s, against 0.06 ms of bytes;
// at EU868 (C = 7, D = 8, 77 taps) 0.017 ms. This kernel issues, a channel
// and output, (T + K - 1)/T * 8D FMA-pipe instructions for the mix (two
// complex products a staged sample and channel) and 2DK for the taps, K
// rounded up to whole passes of tap rows: 911 at US915 against the TPU
// kernel's folded form's 4DK = 1,280; its floor on the FMA pipe is 0.28 ms
// there (chip_smoke.fused_kernel_ops).
//
// Design. A block of kThreads = 128 threads owns kT = 256 outputs and kCh =
// 8 channels (channels past C are zero and not stored); thread t owns
// channel t / 16 and the kR = 16 consecutive outputs 16 (t % 16) + r: 32
// float32 sums. The block walks stages of kDc = 4 phases d and up to kJ =
// 16 tap rows j (all K rows in one pass when K <= 16; else ceil(K / 16)
// passes of J = ceil(K / passes) rows, the rows past K with zero taps;
// the kernel is instantiated for J = 1 .. 16). A stage is:
//  - staged input: rows q < kT + J - 1 of its phases, phase-major, (re, im)
//    pairs, with its phi and taps, by 4-byte cp.async into one of two
//    buffers (the planes' odd length allows no wider copy). Stage s + 1 is
//    in flight while stage s's taps are summed. rho for the block's 8
//    channels is copied with the first stage of each pass of tap rows.
//  - the mix pass: a thread takes a row q, loads rho_c[q] once a channel,
//    and writes z[c][dd][q] = x[dd][q] * (rho_c[q] * phi_c[d0 + dd]) for its
//    8 channels and the stage's 4 phases: each staged sample is mixed once
//    a channel. z stores row q at (q % 16) * kP + q / 16 (kP = 17, odd), so
//    a warp's 16 consecutive rows land on 16 distinct bank pairs.
//  - the tap pass: for each phase a thread reads its R + J - 1 window
//    values of z once (at kP-strided slots; the 16 lanes of a channel read
//    16 consecutive pairs) and applies the phase's J real taps, held in
//    registers, with 2 FMAs a tap and output.
// The epilogue multiplies by R_c[n0] (one complex product a channel and
// block) and stores through shared memory (z's space), so neighbouring
// lanes store neighbouring outputs. Blocks run channel group fastest, so
// the groups of a tile read its input from L2 together. Shared memory
// (dynamic): z 69,632 B, rho 17,344, input 17,344, phi and taps 1,024;
// 105,344 bytes, two blocks an SM. ptxas (CUDA 12.8): 168 registers at J =
// 10 (156-196 over J = 1 .. 16), no spills, no static shared memory.
//
// What holds it back (tune/fused_chan_variants.py on an H100, 700 W): at
// US915 it takes ~0.83 ms, a third of the float32 rate on what it issues.
// Cutting out one part at a time (2 phases a stage, 3 blocks an SM, 0.86
// ms): the restaging of later stages costs 0.23 ms (each 4-byte copy of a
// warp touches 32 / kDc rows D floats apart, so a stage's copies gather a
// whole sector for 8-16 bytes of each plane's row), the mix pass 0.29 ms
// (16 64-bit shared stores a row, 265 rows on 128 threads) and the tap
// pass 0.22 ms. More phases a stage gather less but leave fewer blocks an
// SM: 4 phases (2 blocks) beat 2 (3 blocks) by 4 % at US915 and lose 6 %
// at EU868; 8 phases fit one block an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                   // threads a block
constexpr int kCh = 8;                          // channels a block
constexpr int kR = 16;                          // consecutive outputs a thread
constexpr int kDc = 4;                          // phases a stage
constexpr int kJ = 16;                          // most tap rows a stage
constexpr int kMinBlocks = 2;                   // blocks an SM the registers allow
constexpr int kG = kThreads / kCh;              // output groups a channel
constexpr int kT = kG * kR;                     // outputs a block
constexpr int kSpan = kT + kJ - 1;              // most staged rows a stage
constexpr int kP = ((kSpan + kR - 1) / kR) | 1; // z's slot pitch: odd, >= rows / kR
static_assert(kThreads % kCh == 0, "a channel takes whole output groups");
static_assert(kP * kR >= kSpan, "z must hold the stage's rows");
// the epilogue's [kCh][2][kG][kR + 1] floats reuse z's space
static_assert(kCh * 2 * kG * (kR + 1) <= kCh * kDc * kR * kP * 2, "z must hold the outputs");

constexpr int kZ = kCh * kDc * kR * kP;         // float2 of z
constexpr int kRho = kCh * kSpan;               // float2 of rho
constexpr int kX = 2 * kDc * kSpan;             // float2 of the two input buffers
constexpr int kPhi = 2 * kCh * kDc;             // float2 of the two phi buffers
constexpr int kH = 2 * kDc * kJ;                // floats of the two tap buffers
constexpr size_t kSmemBytes = (size_t)(kZ + kRho + kX + kPhi) * 8 + (size_t)kH * 4;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

struct Args {
  const float* x;
  int64_t x_plane, L;
  const float* h;
  const float* phi;
  int C, D, K, passes, groups;
  const float *o_re, *o_im;
  int64_t nb;
  const float *i_re, *i_im;
  int tile;
  float* out;
  int64_t n_out;
};

template <int J>
__global__ void __launch_bounds__(kThreads, kMinBlocks) fused_chan_kernel(const Args a) {
  constexpr int kRows = kT + J - 1;             // staged rows a stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* zs = reinterpret_cast<float2*>(smem_raw);
  float2* rho = zs + kZ;
  float2* xs = rho + kRho;
  float2* phs = xs + kX;
  float* hs = reinterpret_cast<float*>(phs + kPhi);

  const int tid = threadIdx.x;
  const int grp = (int)(blockIdx.x % (unsigned)a.groups);
  const int64_t n0 = (int64_t)(blockIdx.x / (unsigned)a.groups) * kT;
  const int c0 = grp * kCh;
  const int D = a.D;
  const int nd = (D + kDc - 1) / kDc;            // stages a pass of tap rows
  const int n_stages = a.passes * nd;

  // copy stage s into buffer buf (and, on a pass's first stage, rho)
  auto issue = [&](int s, int buf) {
    const int pass = s / nd;
    const int d0 = (s - pass * nd) * kDc;
    const int j0 = pass * J;
    const int64_t row0 = n0 + j0;
    for (int e = tid; e < kDc * kRows; e += kThreads) {
      const int q = e / kDc;
      const int dd = e - q * kDc;
      const int64_t idx = (row0 + q) * D + d0 + dd;
      const bool ok = d0 + dd < D && idx < a.L;
      float2* dst = xs + (buf * kDc + dd) * kSpan + q;
      cp_async4(&dst->x, a.x + (ok ? idx : 0), ok);
      cp_async4(&dst->y, a.x + a.x_plane + (ok ? idx : 0), ok);
    }
    if (tid < kCh * kDc * 2) {                   // phi: (channel, phase, re | im)
      const int cl = tid / (kDc * 2);
      const int dd = (tid / 2) % kDc;
      const int p = tid % 2;
      const int c = c0 + cl;
      const bool ok = c < a.C && d0 + dd < D;
      const int64_t idx = ((int64_t)c * 2 + p) * D + d0 + dd;
      cp_async4(reinterpret_cast<float*>(phs + (buf * kCh + cl) * kDc + dd) + p,
                a.phi + (ok ? idx : 0), ok);
    }
    for (int e = tid; e < kDc * J; e += kThreads) {   // taps: (phase, row)
      const int dd = e / J;
      const int jj = e - dd * J;
      const bool ok = j0 + jj < a.K && d0 + dd < D;
      const int64_t idx = (int64_t)(j0 + jj) * D + d0 + dd;
      cp_async4(hs + (buf * kDc + dd) * kJ + jj, a.h + (ok ? idx : 0), ok);
    }
    if (d0 == 0) {
      // rho_c[q] = i[c, j0 + q]; rows past kT + K - 2 meet only zero taps
      for (int e = tid; e < kCh * kRows; e += kThreads) {
        const int cl = e / kRows;
        const int q = e - cl * kRows;
        const int c = c0 + cl;
        const int qr = j0 + q;
        const bool ok = c < a.C && qr < kT + a.K - 1;
        const int64_t idx = ok ? (int64_t)c * a.tile + qr : 0;
        cp_async4(&rho[cl * kSpan + q].x, a.i_re + idx, ok);
        cp_async4(&rho[cl * kSpan + q].y, a.i_im + idx, ok);
      }
    }
  };

  const int cl = tid / kG;                       // the tap pass's channel
  const int g = tid - cl * kG;                   // and output group
  float acc_re[kR], acc_im[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc_re[r] = acc_im[r] = 0.f;

  issue(0, 0);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    // stage s has landed (each thread's own copies, then everyone's), and
    // every thread is done with the previous tap pass's reads of z
    cp_async_wait_all();
    __syncthreads();

    // mix pass: z[c][dd][q] = x[dd][q] * rho_c[q] * phi_c[d0 + dd]
    {
      float2 f[kCh][kDc];
#pragma unroll
      for (int c = 0; c < kCh; ++c)
#pragma unroll
        for (int dd = 0; dd < kDc; ++dd) f[c][dd] = phs[(buf * kCh + c) * kDc + dd];
      for (int q = tid; q < kRows; q += kThreads) {
        float2 xv[kDc];
#pragma unroll
        for (int dd = 0; dd < kDc; ++dd) xv[dd] = xs[(buf * kDc + dd) * kSpan + q];
        const int slot = (q % kR) * kP + q / kR;
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          const float2 r = rho[c * kSpan + q];
#pragma unroll
          for (int dd = 0; dd < kDc; ++dd)
            zs[(c * kDc + dd) * (kR * kP) + slot] = cmul(xv[dd], cmul(r, f[c][dd]));
        }
      }
    }
    // z is complete; nothing reads this stage's input buffer or rho again,
    // so the next stage's copies may land there while the taps are summed
    __syncthreads();
    if (s + 1 < n_stages) issue(s + 1, buf ^ 1);
    cp_async_commit();

    // tap pass: output 16 g + r of channel cl takes row 16 g + r + jj
    // through tap jj
#pragma unroll
    for (int dd = 0; dd < kDc; ++dd) {
      float hv[J];
#pragma unroll
      for (int jj = 0; jj < J; ++jj) hv[jj] = hs[(buf * kDc + dd) * kJ + jj];
      const float2* zp = zs + (cl * kDc + dd) * (kR * kP) + g;
#pragma unroll
      for (int m = 0; m < kR + J - 1; ++m) {
        const float2 v = zp[(m % kR) * kP + m / kR];
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          const int r = m - jj;
          if (r >= 0 && r < kR) {
            acc_re[r] = fmaf(hv[jj], v.x, acc_re[r]);
            acc_im[r] = fmaf(hv[jj], v.y, acc_im[r]);
          }
        }
      }
    }
  }

  // epilogue: times R_c[n0], staged as [kCh][2][kG][kR + 1] floats in z's
  // space, then stored with neighbouring lanes on neighbouring outputs
  float2 rr = make_float2(0.f, 0.f);
  const int c = c0 + cl;
  if (c < a.C) {
    const int64_t blk = n0 / a.tile;
    const int64_t lane = n0 - blk * a.tile;
    rr = cmul(make_float2(a.o_re[c * a.nb + blk], a.o_im[c * a.nb + blk]),
              make_float2(a.i_re[c * (int64_t)a.tile + lane], a.i_im[c * (int64_t)a.tile + lane]));
  }
  __syncthreads();  // every tap pass is done with z
  float* ys = reinterpret_cast<float*>(zs);
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float2 y = cmul(rr, make_float2(acc_re[r], acc_im[r]));
    ys[((cl * 2 + 0) * kG + g) * (kR + 1) + r] = y.x;
    ys[((cl * 2 + 1) * kG + g) * (kR + 1) + r] = y.y;
  }
  __syncthreads();
  for (int e = tid; e < kCh * 2 * kT; e += kThreads) {
    const int row = e / kT;                      // (channel, re | im)
    const int nl = e - row * kT;
    const int ch = c0 + row / 2;
    const int64_t n = n0 + nl;
    if (ch < a.C && n < a.n_out)
      a.out[((int64_t)ch * 2 + row % 2) * a.n_out + n] =
          ys[(row * kG + nl / kR) * (kR + 1) + nl % kR];
  }
}

// the instantiation for j tap rows a pass, 1 <= j <= J
template <int J>
int launch(const Args& a, int j, unsigned blocks, cudaStream_t stream) {
  if constexpr (J > 1) {
    if (j < J) return launch<J - 1>(a, j, blocks, stream);
  }
  auto kern = fused_chan_kernel<J>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<blocks, kThreads, kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x: float32 planes, plane p at x + p * x_plane, L contiguous samples each;
// h: float32 [K*D], the taps zero-padded; phi: float32 [C, 2, D]; o_re,
// o_im: float32 [C, nb]; i_re, i_im: float32 [C, tile]; out: float32 [C, 2,
// n_out] contiguous, with n_out <= nb * tile. Needs 256 + K - 1 <= tile
// (else cudaErrorInvalidValue). All on the calling thread's current CUDA
// device. Launches on `stream` without synchronising and returns the
// launch's cudaError_t.
extern "C" int fused_chan_launch(const void* x, long long x_plane, long long L, const void* h,
                                 const void* phi, int C, int D, int K, const void* o_re,
                                 const void* o_im, long long nb, const void* i_re,
                                 const void* i_im, int tile, void* out, long long n_out,
                                 void* stream) {
  if (C < 1 || D < 1 || K < 1 || tile < 1 || L < 1 || n_out < 1 || nb * tile < n_out ||
      (long long)kT + K - 1 > tile)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = (n_out + kT - 1) / kT;
  const int64_t groups = (C + kCh - 1) / kCh;
  if (tiles * groups > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int passes = (K + kJ - 1) / kJ;
  const int J = (K + passes - 1) / passes;       // tap rows a pass, 1 .. kJ
  const Args a{static_cast<const float*>(x), x_plane, L, static_cast<const float*>(h),
               static_cast<const float*>(phi), C, D, K, passes, (int)groups,
               static_cast<const float*>(o_re), static_cast<const float*>(o_im), nb,
               static_cast<const float*>(i_re), static_cast<const float*>(i_im), tile,
               static_cast<float*>(out), n_out};
  return launch<kJ>(a, J, (unsigned)(tiles * groups), static_cast<cudaStream_t>(stream));
}

extern "C" const char* fused_chan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
