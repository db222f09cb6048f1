// Mix + decimating FIR + output ramp over a LoRaWAN channel plan, for
// Hopper (sm_90a): two kernels of one function, both on CUDA cores in
// float32, both applying the mixer to the input per channel and then the
// real taps. ops/cuda_kernels.fused_chan_path picks one a launch.
//
// Both replace the TPU kernel lora_tpu/ops/pallas_kernels.py:_fused_chan_kernel
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
// Im, [C, 2, n_out] contiguous float32. A kernel's unit of work owns the
// outputs from n0 on; with q = n - n0 + j the phasor splits as
//
//   exp(-2 pi i a_c ((n0 + q)*D + d)) = R_c[n0] * rho_c[q] * phi_c[d]
//   R_c[n0] = o[c, n0 / tile] * i[c, n0 % tile],   rho_c[q] = i[c, q]
//
// so q must stay below tile. Every phase is reduced in float64 on the host;
// the device forms only products of float32 phasors.
//
// What bounds the function: float32 operations. It needs at least 6D + 4
// n_taps flops a channel and output (chip_smoke.fused_min_ops): at the
// benchmark cell's plan (C = 64, D = 64, 617 taps, K = 10, a block of
// 546,702,016 samples, n_out = 8,542,210) 1.56 TFLOP, 23.27 ms at the H100
// SXM data-sheet 67 TFLOP/s, against 2.6 ms of bytes; at the US915 smoke
// shape (C = 23, D = 32, 309 taps, n_out = 450,551) 0.22 ms; at EU868 (C =
// 7, D = 8, 77 taps) 0.017 ms.
//
// Which kernel (fused_chan_path; the wrapper counts chan.k5.wide or
// chan.k5.narrow a launch). The wide one where every row of D samples is
// 16-byte aligned (D % 4 == 0, x and x_plane aligned), 8 <= K <= 10 (its
// instantiations), D <= 128 (its shared memory), and C >= 17 and D >= 16;
// the first kernel takes every other launch. The thresholds are where the
// wide kernel starts to win, both timed in turns at n_out = 450,551, K = 10
// (H100 80GB HBM3, 700 W): at D = 64 the first kernel takes 1.10 ms at C =
// 16 and 1.55 at C = 17 (its channels come in groups of 8) against the
// wide one's 1.29 and 1.30; at D = 32, 0.58 at C = 16 and 0.82 at C = 20
// against 0.64 and 0.64; at D = 16 0.30 at C = 16, 0.43 at C = 24 against
// 0.38 and 0.40; at D = 8 the wide one never wins (1.03x at C = 32, 1.05x
// at C = 64). At the three plans: the cell 76.5 ms against 42.1 (wide),
// US915 0.824 against 0.655 (wide), EU868 0.092 against 0.247 (first).
//
// ------------------------------------------------------------------------
// The first kernel (fused_chan_kernel, fused_chan_launch). It issues, a
// channel and output, (T + K - 1)/T * 8D FMA-pipe instructions for the mix
// (two complex products a staged sample and channel) and 2DK for the taps,
// K rounded up to whole passes of tap rows: 911 at US915 against the TPU
// kernel's folded form's 4DK = 1,280; its floor on the FMA pipe is 0.28 ms
// there (chip_smoke.fused_kernel_ops). It needs kT + K - 1 <= tile (the
// launcher refuses a larger K).
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
// at EU868; 8 phases fit one block an SM. With 64 channels its 8 channel
// groups each restage a tile's input.
//
// ------------------------------------------------------------------------
// The wide-plan kernel (fused_chan_wide_kernel, fused_chan_wide_launch;
// fused_chan_wide_geometry reports its launch). A lane is a channel: a
// warp holds 32 channels at the same rows, so every read of staged input
// or taps is a broadcast, and a sample is mixed in registers, never stored.
// The row ramp multiplies after the sum over phases: with t_j[m] = sum_d
// h[j D + d] * phi_c[d] * x[m D + d],
//
//   y_c[rs + e] = R_c[rs] * sum_j rho_c[e + j] * t_j[rs + e + j]
//
// so a channel and row issue 4D (phi * x) + 2DK (the taps) + 4K (the row
// ramp) FMA-pipe instructions, and an output 4 more (R_c[rs]): 1,594 at the
// cell against the first kernel's 1,810; its floor on the FMA pipe is 26.0
// ms there (chip_smoke.fused_kernel_ops with the launch's rows a run).
//
// Design. A block of kWarps = 8 warps owns up to 64 channels (32 cw, cw =
// 1 or 2 warps a run) and runs = 8 / cw runs of rr rows (rr <= tile, a
// multiple of kS; the launcher takes the longest run the tile allows
// unless a shorter one ends the grid's last wave sooner: 1,024 at the
// cell). A run's rows rs .. rs + rr - 1 complete its rr - K + 1 outputs
// from rs on (its first K - 1 rows only finish outputs of the run before).
//  - The ring: kNS = 3 stages of kS = 8 rows of every run, each (run,
//    plane) one contiguous run of 8 D samples, brought in by one bulk copy
//    (cp.async.bulk, completing on the stage's full mbarrier; where a
//    region runs past the planes' end the rest is read one sample at a
//    time, zero past L). Warp 0 fills stage k + 1 at the start of stage k,
//    once the empty mbarrier says every warp is done with stage k - 2. No
//    __syncthreads inside the stage loop.
//  - A step takes kG = 2 rows i, i + 1. For each block of 4 phases a lane
//    loads its channel's 4 phases of phi (two 16-byte loads) and forms v =
//    phi * x for both rows from their staged input (16-byte broadcasts,
//    loaded one block ahead), then for each tap row j one 16-byte
//    broadcast of h[j D + d0 .. d0 + 3] feeds 16 FMAs into t[g][j] (2 x K
//    complex sums).
//  - After the phases, acc[g - j + K - 1] += rho_c[i + g] * t[g][j] into a
//    window of K + 1 outputs held in registers; the two outputs it
//    completes are multiplied by R_c[rs] and staged per lane in shared
//    memory; every 8 outputs the warp stores its 32 channels' rows, each
//    store instruction 4 rows x 8 consecutive outputs of one plane.
// Shared memory (dynamic) at the cell: ring 49,152 B, phi 32,768 (pairs of
// phases, lane-major), taps 2,560, output staging 19,456, barriers 128;
// 104,064 bytes, two blocks an SM (16 warps). ptxas (CUDA 12.8): 128
// registers at K = 8 and 10, 122 at K = 9 (128 is the cap two blocks of
// 256 threads leave), no spills, no static shared memory. Timed in turns against the first kernel
// (H100 80GB HBM3, 700 W): the cell's whole block 42.1-42.9 ms against
// 76.1-76.6 (54-55 % of the least-work bound, 61-62 % of the FMA rate on
// what it issues). What holds it back: the shared
// memory loads, 16 a block of 4 phases against 192 FMAs; without them (a
// timing-only cut) the taps alone run at 80 % of the FMA rate. Cuts that
// did not pay: one row a step (fewer sums, one load per 24 FMAs: 52.8 ms),
// unrolling the phase loop (spills), taps from __constant__ memory with
// the phases unrolled (112 ms) or indexed (92 ms).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

// ------------------------------------------------------------ wide plans
//
// The second kernel (see the note at the top): a lane is a channel, a warp
// 32 channels walking a run of rows, the row ramp applied after the sum
// over phases. Shares no device code with the kernel above.

namespace {
namespace wide {

constexpr int kG = 2;                  // rows a step: a lane sums kG rows at once
constexpr int kS = 8;                  // rows a stage of the ring
constexpr int kNS = 3;                 // stages in the ring
constexpr int kWarps = 8;              // warps a block; warp 0 also fills the ring
constexpr int kThreads = kWarps * 32;
constexpr int kAhead = kNS - 2;        // stages filled ahead of the one being summed
constexpr int kBlocksPerSm = 2;        // blocks an SM the registers must allow
constexpr int kSO = 8;                 // outputs a warp stages before it stores them
constexpr int kOP = 2 * kSO + 3;       // a lane's pitch there (and R_c[rs]): odd, no bank conflicts
constexpr int kKMin = 8, kKMax = 10;   // tap rows the kernel is instantiated for
constexpr int kBarBytes = 128;         // the ring's barriers, ahead of the staged input
static_assert(kS % kG == 0, "a stage holds whole steps");

// The PTX this kernel issues: mbarriers, bulk copies, the proxy fence.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar's transaction count
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

struct Args {
  const float* x;
  int64_t x_plane, L;
  const float* h;
  const float* phi;
  int C, D, K;
  const float *o_re, *o_im;
  int64_t nb;
  const float *i_re, *i_im;
  int tile;
  float* out;
  int64_t n_out;
  int cw;            // channel warps a run: 1 (32 channels a block) or 2 (64)
  int runs;          // row runs a block, kWarps / cw
  int rr;            // rows a run: a multiple of kS, <= tile
  int run_out;       // outputs a run, rr - K + 1
};

// shared memory: the barriers, the ring [kNS][runs][2][kS * D], the phase
// table (D * 32 cw float2), the taps (D * K), the output staging [kWarps][32][kOP]
inline size_t smem_bytes(int D, int cw, int K) {
  return kBarBytes + (size_t)kNS * (kWarps / cw) * 2 * kS * D * 4 + (size_t)D * 32 * cw * 8 +
         (size_t)D * K * 4 + (size_t)kWarps * 32 * kOP * 4;
}

template <int K>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) fused_chan_wide_kernel(const Args a) {
  constexpr int kW = K + kG - 1;                 // the outputs a step touches
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kNS;
  const int D = a.D;
  const int CB = 32 * a.cw;                      // channels a block
  const int slot_floats = a.runs * 2 * kS * D;
  float* xs = reinterpret_cast<float*>(smem_raw + kBarBytes);
  float2* phis = reinterpret_cast<float2*>(xs + kNS * slot_floats);
  float* hs = reinterpret_cast<float*>(phis + D * CB);
  float* os = hs + D * K;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = blockIdx.y * CB;
  const int64_t out0 = (int64_t)blockIdx.x * a.runs * a.run_out;  // the block's first output
  const int stages = a.rr / kS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kNS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    mbar_init_fence();
  }
  // phi_c[d] for the block's channels as [D / 2][CB] pairs of phases (a
  // lane's two phases one 16-byte load); the taps as [D / 4][K] runs of 4
  // phases (h[j D + d0 .. d0 + 3] one 16-byte load)
  for (int e = threadIdx.x; e < D * CB; e += kThreads) {
    const int d = e / CB;
    const int c = c0 + e - d * CB;
    phis[((d >> 1) * CB + e - d * CB) * 2 + (d & 1)] =
        c < a.C ? make_float2(a.phi[((int64_t)c * 2) * D + d], a.phi[((int64_t)c * 2 + 1) * D + d])
                : make_float2(0.f, 0.f);
  }
  for (int e = threadIdx.x; e < D * K; e += kThreads) {
    const int j = e / D;
    const int d = e - j * D;
    hs[((d >> 2) * K + j) * 4 + (d & 3)] = a.h[e];
  }
  __syncthreads();

  // warp 0 fills the ring: stage k holds rows [k kS, (k + 1) kS) of every
  // run, each (run, plane) one contiguous run of kS * D samples, copied in
  // bulk where 16-byte aligned and inside the planes, the rest read one
  // sample at a time (zero past L)
  const int regions = a.runs * 2;
  auto fill = [&](int k) {
    const int slot = k % kNS;
    float* const base = xs + slot * slot_floats;
    // lane r < regions: region r, (run r / 2, plane r % 2)
    const int64_t s0 = (out0 + (int64_t)(lane / 2) * a.run_out + (int64_t)k * kS) * D;
    const int64_t left = lane < regions ? a.L - s0 : 0;
    const int valid = left <= 0 ? 0 : left >= kS * D ? kS * D : (int)left;
    const int bulk = valid & ~3;
    // near the planes' end: the samples past a region's aligned part
    unsigned ragged = __ballot_sync(~0u, lane < regions && bulk < kS * D);
    while (ragged) {
      const int r = __ffs(ragged) - 1;
      ragged &= ragged - 1;
      const int rb = __shfl_sync(~0u, bulk, r);
      const int rv = __shfl_sync(~0u, valid, r);
      const int64_t rs0 = __shfl_sync(~0u, s0, r);
      float* dst = base + r * kS * D;
      const float* src = a.x + (r % 2) * a.x_plane + rs0;
      for (int e = rb + lane; e < kS * D; e += 32) dst[e] = e < rv ? src[e] : 0.f;
    }
    const unsigned tx = __reduce_add_sync(~0u, (unsigned)bulk * 4);
    __syncwarp();
    if (lane == 0) mbar_arrive_tx(&full[slot], tx);
    __syncwarp();
    if (bulk > 0) {
      fence_proxy_async();
      bulk_copy(base + lane * kS * D, a.x + (lane % 2) * a.x_plane + s0, bulk * 4, &full[slot]);
    }
  };
  if (warp == 0)
    for (int k = 0; k < kAhead && k < stages; ++k) fill(k);

  // consumers: warp (run, channel group), lane = channel
  const int run = warp / a.cw;
  const int cl = (warp - run * a.cw) * 32 + lane;   // the lane's channel in the block
  const int c = c0 + cl;
  const int cc = c < a.C ? c : 0;                 // a channel whose tables exist
  const int64_t rs = out0 + (int64_t)run * a.run_out;    // the run's first output and row
  float* stage_out = os + warp * 32 * kOP;        // the warp's output staging
  float* my_out = stage_out + lane * kOP;         // the lane's: re [0, kSO), im [kSO, 2 kSO)
  // R_c[rs], the row ramp at the run's first row, beside the lane's
  // staging; rho_c[i] = i[c, i] after it
  float2 r0 = make_float2(0.f, 0.f);
  if (c < a.C && rs < a.n_out) {
    const int64_t blk = rs / a.tile;
    const int64_t in = rs - blk * a.tile;
    r0 = cmul(make_float2(a.o_re[cc * a.nb + blk], a.o_im[cc * a.nb + blk]),
              make_float2(a.i_re[(int64_t)cc * a.tile + in], a.i_im[(int64_t)cc * a.tile + in]));
  }
  my_out[2 * kSO] = r0.x;
  my_out[2 * kSO + 1] = r0.y;
  const int rho0 = cc * a.tile;

  // acc[w]: output (i - K + 1 + w) of the lane's channel, i the step's first row
  float2 acc[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w) acc[w] = make_float2(0.f, 0.f);

  for (int k = 0; k < stages; ++k) {
    const int slot = k % kNS;
    if (warp == 0 && k + kAhead < stages) {
      // the slot stage k + kAhead takes was last summed at stage k + kAhead - kNS
      const int prev = k + kAhead - kNS;
      if (prev >= 0) mbar_wait(&empty[(k + kAhead) % kNS], (prev / kNS) & 1);
      fill(k + kAhead);
    }
    mbar_wait(&full[slot], (k / kNS) & 1);
    const float* xre = xs + slot * slot_floats + run * 2 * kS * D;
    const float* xim = xre + kS * D;
#pragma unroll 1
    for (int il = 0; il < kS; il += kG) {
      const int i = k * kS + il;                  // the run's row of the step's first row
      // t[g][j] = sum_d h[j D + d] * phi_c[d] * x[i + g][d]
      float2 t[kG][K];
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int j = 0; j < K; ++j) t[g][j] = make_float2(0.f, 0.f);
      // the step's rows at phases d0 .. d0 + 3, loaded one block of phases
      // ahead of the sums
      const float4* pp = reinterpret_cast<const float4*>(phis) + cl;
      float4 xr[kG], xi[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        xr[g] = *reinterpret_cast<const float4*>(xre + (il + g) * D);
        xi[g] = *reinterpret_cast<const float4*>(xim + (il + g) * D);
      }
#pragma unroll 1
      for (int d0 = 0; d0 < D; d0 += 4) {
        // v[u][g] = phi_c[d0 + u] * x[i + g][d0 + u]
        const float4 pa = pp[(d0 >> 1) * CB];
        const float4 pb = pp[((d0 >> 1) + 1) * CB];
        const float2 p[4] = {make_float2(pa.x, pa.y), make_float2(pa.z, pa.w),
                             make_float2(pb.x, pb.y), make_float2(pb.z, pb.w)};
        float2 v[4][kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          v[0][g] = cmul(p[0], make_float2(xr[g].x, xi[g].x));
          v[1][g] = cmul(p[1], make_float2(xr[g].y, xi[g].y));
          v[2][g] = cmul(p[2], make_float2(xr[g].z, xi[g].z));
          v[3][g] = cmul(p[3], make_float2(xr[g].w, xi[g].w));
        }
        const int dn = d0 + 4 < D ? d0 + 4 : d0;
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          xr[g] = *reinterpret_cast<const float4*>(xre + (il + g) * D + dn);
          xi[g] = *reinterpret_cast<const float4*>(xim + (il + g) * D + dn);
        }
        // t[g][j] += h[j D + d0 + u] * v[u][g]
        const float4* hp = reinterpret_cast<const float4*>(hs) + (d0 >> 2) * K;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float4 h4 = hp[j];
          const float hu[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int g = 0; g < kG; ++g) {
              t[g][j].x = fmaf(hu[u], v[u][g].x, t[g][j].x);
              t[g][j].y = fmaf(hu[u], v[u][g].y, t[g][j].y);
            }
        }
      }
      // row i + g reaches output i + g - j through tap row j, times rho_c[i + g]
      float2 rho[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g)
        rho[g] = make_float2(__ldg(a.i_re + rho0 + i + g), __ldg(a.i_im + rho0 + i + g));
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int j = 0; j < K; ++j) {
          float2& y = acc[g - j + K - 1];
          y.x = fmaf(rho[g].x, t[g][j].x, fmaf(-rho[g].y, t[g][j].y, y.x));
          y.y = fmaf(rho[g].x, t[g][j].y, fmaf(rho[g].y, t[g][j].x, y.y));
        }
      // outputs i - K + 1 + g are complete: times R_c[rs], staged, stored
      // by the warp every kSO outputs and at the run's end
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const int e = i + g - (K - 1);            // the output's index in the run
        if (e >= 0 && e < a.run_out) {
          const float2 y = cmul(make_float2(my_out[2 * kSO], my_out[2 * kSO + 1]), acc[g]);
          const int o = e % kSO;
          my_out[o] = y.x;
          my_out[kSO + o] = y.y;
          if (o == kSO - 1 || e == a.run_out - 1) {
            __syncwarp();
            const int64_t n0 = rs + e - o;
            for (int t2 = lane; t2 < 32 * 2 * kSO; t2 += 32) {
              const int row = t2 / kSO;         // (lane, plane)
              const int oo = t2 - row * kSO;
              const int ch = c0 + cl - lane + row / 2;
              const int64_t n = n0 + oo;
              if (oo <= o && ch < a.C && n < a.n_out)
                a.out[((int64_t)ch * 2 + row % 2) * a.n_out + n] =
                    stage_out[(row / 2) * kOP + (row % 2) * kSO + oo];
            }
            __syncwarp();
          }
        }
      }
#pragma unroll
      for (int w = 0; w < kW; ++w) acc[w] = w + kG < kW ? acc[w + kG] : make_float2(0.f, 0.f);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }
}

template <int K>
int launch(const Args& a, unsigned grid_x, unsigned grid_y, size_t smem, cudaStream_t stream) {
  if constexpr (K > kKMin) {
    if (a.K < K) return launch<K - 1>(a, grid_x, grid_y, smem, stream);
  }
  auto kern = fused_chan_wide_kernel<K>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(grid_x, grid_y), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int K>
int blocks_per_sm(int k, size_t smem, int* n) {
  if constexpr (K > kKMin) {
    if (k < K) return blocks_per_sm<K - 1>(k, smem, n);
  }
  auto kern = fused_chan_wide_kernel<K>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kern, kThreads, smem);
}

}  // namespace wide
}  // namespace

namespace {
namespace wide {

// The launch geometry for C channels, D, K tap rows, the ramp's tile and
// n_out outputs on the current device; 0 or the cudaError_t.
struct Geometry {
  int cw, runs, rr, run_out, per_sm;
  long long grid_x, grid_y;
  size_t smem;
};

int plan(int C, int D, int K, int tile, long long n_out, Geometry* g) {
  if (C < 1 || D < 1 || D % 4 || K < kKMin || K > kKMax || tile < kS + K - 1 || n_out < 1)
    return (int)cudaErrorInvalidValue;
  g->cw = C > 32 ? 2 : 1;
  g->runs = kWarps / g->cw;
  g->smem = smem_bytes(D, g->cw, K);
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (g->smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  g->per_sm = 0;
  const int rc = blocks_per_sm<kKMax>(K, g->smem, &g->per_sm);
  if (rc != 0) return rc;
  if (g->per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  g->grid_y = (C + 32 * g->cw - 1) / (32 * g->cw);
  const long long slots = (long long)sms * g->per_sm;
  // rows a run: a run's first K - 1 rows complete no output of its own, so
  // the longest run the ramp's inner table allows (<= tile), unless a
  // shorter one (down to 4 (K - 1) rows) ends the grid's last wave sooner
  const int rr_max = tile / kS * kS;
  const int rr_min = std::min(rr_max, (4 * (K - 1) + kS - 1) / kS * kS);
  long long best = -1;
  for (int r = rr_max; r >= rr_min && r >= K; r -= kS) {
    const long long per_block = (long long)g->runs * (r - K + 1);
    const long long blocks = (n_out + per_block - 1) / per_block * g->grid_y;
    const long long cost = (blocks + slots - 1) / slots * r;
    if (best < 0 || cost < best) {
      best = cost;
      g->rr = r;
    }
  }
  g->run_out = g->rr - K + 1;
  const long long per_block = (long long)g->runs * g->run_out;
  g->grid_x = (n_out + per_block - 1) / per_block;
  if (g->grid_x > 0x7fffffffLL || g->grid_y > 65535) return (int)cudaErrorInvalidConfiguration;
  return 0;
}

}  // namespace wide
}  // namespace

// The wide-plan kernel: the same arguments and result as fused_chan_launch.
// Needs D a multiple of 4, kKMin <= K <= kKMax, x and x_plane 16-byte
// aligned (x_plane a multiple of 4 floats), kS + K - 1 <= tile and the
// shared memory for D (else cudaErrorInvalidValue).
extern "C" int fused_chan_wide_launch(const void* x, long long x_plane, long long L,
                                      const void* h, const void* phi, int C, int D, int K,
                                      const void* o_re, const void* o_im, long long nb,
                                      const void* i_re, const void* i_im, int tile, void* out,
                                      long long n_out, void* stream) {
  using namespace wide;
  if (L < 1 || nb * tile < n_out || reinterpret_cast<uintptr_t>(x) % 16 || x_plane % 4)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  const int rc = plan(C, D, K, tile, n_out, &g);
  if (rc != 0) return rc;
  const wide::Args a{static_cast<const float*>(x), x_plane, L, static_cast<const float*>(h),
               static_cast<const float*>(phi), C, D, K,
               static_cast<const float*>(o_re), static_cast<const float*>(o_im), nb,
               static_cast<const float*>(i_re), static_cast<const float*>(i_im), tile,
               static_cast<float*>(out), n_out, g.cw, g.runs, g.rr, g.run_out};
  return launch<kKMax>(a, (unsigned)g.grid_x, (unsigned)g.grid_y, g.smem,
                       static_cast<cudaStream_t>(stream));
}

// The wide kernel's launch geometry, launching nothing: geom[0..7] = rows a
// run, outputs a run, runs a block, channel warps a run, blocks along the
// outputs, blocks along the channels, resident blocks an SM, shared memory
// bytes a block. Returns 0 or the cudaError_t fused_chan_wide_launch would.
extern "C" int fused_chan_wide_geometry(int C, int D, int K, int tile, long long n_out,
                                        long long* geom) {
  wide::Geometry g;
  const int rc = wide::plan(C, D, K, tile, n_out, &g);
  if (rc != 0) return rc;
  const long long v[8] = {g.rr, g.run_out, g.runs, g.cw, g.grid_x, g.grid_y, g.per_sm,
                          (long long)g.smem};
  for (int i = 0; i < 8; ++i) geom[i] = v[i];
  return 0;
}
