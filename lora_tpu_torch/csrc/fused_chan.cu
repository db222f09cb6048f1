// Fused mix + decimating FIR + output ramp over a LoRaWAN channel plan,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel lora_tpu/ops/pallas_kernels.py:_fused_chan_kernel
// (with its callers _fused_chan_call and fused_channelize_pallas). For the
// packed wideband planes x[2, L] float32 (plane p starts at x + p * x_plane,
// its samples contiguous), the folded FIR matrix g2[2C, K*2D] float32 (row
// r < C the real output of channel r, row C + r its imaginary output;
// feature f = j*2D + p*D + d multiplies plane p's sample (n + j)*D + d),
// and the ramp factors o_re, o_im [C, nb] and i_re, i_im [C, tile], every
// channel c < C and output n < n_out = (L - n_taps)/D + 1 gets
//
//   s_re = sum_{j<K, p<2, d<D} g2[c,     j*2D + p*D + d] * x[p, (n+j)*D + d]
//   s_im = sum_{j<K, p<2, d<D} g2[C + c, j*2D + p*D + d] * x[p, (n+j)*D + d]
//   (rr, ri) = o[c, n / tile] * i[c, n % tile]            (complex product)
//   out[c, 0, n] = rr*s_re - ri*s_im,   out[c, 1, n] = ri*s_re + rr*s_im
//
// with samples at index >= L read as zero (the last outputs reach past L
// where the zero-padded taps sit). The sums are float32 fused multiply-adds
// in the order j-chunk, d-chunk, j, d; the ramp is applied in float32 with
// the plain version's product order and no contraction (__fmul_rn etc.).
// The output is [C, 2, n_out] contiguous float32.
//
// What bounds it: float32 operations. The function needs at least 6D +
// 4 n_taps flops a channel and output: mix each input sample once (a
// complex product, D samples an output), then apply the real taps to the
// mixed samples (a real-by-complex multiply-add a tap). At the US915 plan
// shape (C = 23, D = 32, 309 taps, K = 10, n_out = 450,551) that is 14.8
// GFLOP, 0.22 ms at the H100 SXM data-sheet 67 TFLOP/s, against 0.06 ms for
// its 198 MB of bytes; at EU868 (C = 7, D = 8, 77 taps) 1.12 GFLOP, 0.017
// ms, against 0.016 ms of bytes. This kernel computes the TPU kernel's
// folded form instead, with its tables: the mixer folded into complex taps
// g2, the zero-padded taps included, 2C x 2DK multiply-adds an output (8DK
// flops a channel), 26.5 GFLOP at US915, 1.8x the least. A kernel that
// mixes its staged input per channel and then applies the real taps would
// do the least; it is not written.
//
// Design. A block of 128 threads owns a tile of kT = 512 outputs and a group
// of kCh = 8 channels (blockIdx.y; channels past C are zero and not
// stored). Thread t owns outputs t + 128 i, i < kR = 4, of all 8 channels:
// 64 float32 sums in registers. The block walks the taps in stages of up
// to kJ = 12 tap rows j and kDc = 8 phases d. A stage copies into shared
// memory the input it needs, phase-major (row dd holds samples (n0 + j0 +
// q)*D + d0 + dd as (re, im) pairs): a thread reading x[(n + j)*D + d] from
// a linear stage would hit one bank from every lane at D = 32, where the
// phase-major rows put neighbouring lanes on neighbouring pairs. The row
// pitch is 2 mod 16 pairs, so a half-warp's staging stores (8 phases x 2
// samples, 64 bits each) fall on distinct banks too. The stage also copies
// g2's entries for its (j, d) and the block's channels as one float4 (a0,
// a1, b0, b1) per channel, which every lane of a warp reads at one address
// (broadcast). A (j, d) step then loads 4 input pairs and 8 float4s and
// does 128 multiply-adds: each staged sample serves 8 channels x 2 rows,
// each g2 entry 512 outputs. The stage's halo is its kJ - 1 extra rows;
// nothing carries between blocks. Any C, D >= 1, K >= 1 and L is taken:
// more channels add blocks, more phases or taps add stages, so there is no
// geometry the wrapper has to route elsewhere. A stage is staged by plain
// loads and stores (the planes' odd length allows no aligned vector copy):
// the four blocks an SM hide one another's staging, and 4-byte cp.async
// copies tied at US915, faster only at EU868's smaller shape
// (tune/fused_chan_variants.py). What holds the kernel at about 45 % of
// the float32 rate on its folded form (about a quarter of the function's
// operations bound) is the inner loop: the
// variants with more registers a thread, or fewer channels or outputs a
// thread, are all slower. Tensor cores (3xTF32) are not used.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                  // threads a block
constexpr int kR = 4;                          // outputs a thread
constexpr int kT = kThreads * kR;              // outputs a block
constexpr int kCh = 8;                         // channels a block
constexpr int kJ = 12;                         // tap rows a stage
constexpr int kDc = 8;                         // phases a stage
constexpr int kSpan = kT + kJ - 1;             // staged samples a phase row
constexpr int kPitch = (kSpan + 15) / 16 * 16 + 2;  // 2 mod 16 pairs
static_assert(kPitch >= kSpan, "the phase row must hold the stage's span");

__global__ void __launch_bounds__(kThreads)
fused_chan_kernel(const float* __restrict__ x, int64_t x_plane, int64_t L,
                  const float* __restrict__ g2, int C, int D, int K,
                  const float* __restrict__ o_re, const float* __restrict__ o_im,
                  int64_t nb, const float* __restrict__ i_re,
                  const float* __restrict__ i_im, int tile,
                  float* __restrict__ out, int64_t n_out) {
  __shared__ float2 xs[kDc * kPitch];
  __shared__ float4 gs[kJ * kDc * kCh];

  const int tid = threadIdx.x;
  const int64_t n0 = (int64_t)blockIdx.x * kT;
  const int c0 = blockIdx.y * kCh;
  const int64_t F = (int64_t)K * 2 * D;   // g2 row length

  float acc_re[kCh][kR], acc_im[kCh][kR];
#pragma unroll
  for (int c = 0; c < kCh; ++c)
#pragma unroll
    for (int i = 0; i < kR; ++i) acc_re[c][i] = acc_im[c][i] = 0.f;

  for (int j0 = 0; j0 < K; j0 += kJ) {
    const int nj = K - j0 < kJ ? K - j0 : kJ;
    const int span = kT + nj - 1;
    for (int d0 = 0; d0 < D; d0 += kDc) {
      const int nd = D - d0 < kDc ? D - d0 : kDc;
      __syncthreads();  // the previous stage's reads are done
      // input: phase dd, staged sample q -> x[(n0 + j0 + q)*D + d0 + dd]
      for (int e = tid; e < span * nd; e += kThreads) {
        const int q = e / nd;
        const int dd = e - q * nd;
        const int64_t idx = (n0 + j0 + q) * D + d0 + dd;
        const bool in = idx < L;
        xs[dd * kPitch + q] = in ? make_float2(x[idx], x[x_plane + idx]) : make_float2(0.f, 0.f);
      }
      // g2: (jj, dd, channel) -> (a0, a1, b0, b1)
      for (int e = tid; e < nj * nd * kCh; e += kThreads) {
        const int cl = e % kCh;
        const int rest = e / kCh;
        const int dd = rest % nd;
        const int jj = rest / nd;
        const int c = c0 + cl;
        float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c < C) {
          const int64_t col = (int64_t)(j0 + jj) * 2 * D + d0 + dd;
          const float* a = g2 + c * F + col;
          const float* b = g2 + (C + c) * F + col;
          w = make_float4(a[0], a[D], b[0], b[D]);
        }
        gs[(jj * kDc + dd) * kCh + cl] = w;
      }
      __syncthreads();
      for (int jj = 0; jj < nj; ++jj) {
        for (int dd = 0; dd < nd; ++dd) {
          float2 xv[kR];
#pragma unroll
          for (int i = 0; i < kR; ++i) xv[i] = xs[dd * kPitch + jj + tid + i * kThreads];
          const float4* g = gs + (jj * kDc + dd) * kCh;
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            const float4 w = g[c];
#pragma unroll
            for (int i = 0; i < kR; ++i) {
              acc_re[c][i] = fmaf(w.x, xv[i].x, acc_re[c][i]);
              acc_re[c][i] = fmaf(w.y, xv[i].y, acc_re[c][i]);
              acc_im[c][i] = fmaf(w.z, xv[i].x, acc_im[c][i]);
              acc_im[c][i] = fmaf(w.w, xv[i].y, acc_im[c][i]);
            }
          }
        }
      }
    }
  }

  // the output ramp, then [C, 2, n_out]; neighbouring lanes store
  // neighbouring outputs
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int64_t n = n0 + tid + i * kThreads;
    if (n >= n_out) continue;
    const int64_t blk = n / tile;
    const int lane = (int)(n - blk * tile);
#pragma unroll
    for (int cl = 0; cl < kCh; ++cl) {
      const int c = c0 + cl;
      if (c >= C) continue;
      const float ore = o_re[c * nb + blk], oim = o_im[c * nb + blk];
      const float ir = i_re[(int64_t)c * tile + lane], ii = i_im[(int64_t)c * tile + lane];
      const float rr = __fsub_rn(__fmul_rn(ore, ir), __fmul_rn(oim, ii));
      const float ri = __fadd_rn(__fmul_rn(ore, ii), __fmul_rn(oim, ir));
      const float sr = acc_re[cl][i], si = acc_im[cl][i];
      float* o = out + (int64_t)c * 2 * n_out + n;
      o[0] = __fsub_rn(__fmul_rn(rr, sr), __fmul_rn(ri, si));
      o[n_out] = __fadd_rn(__fmul_rn(ri, sr), __fmul_rn(rr, si));
    }
  }
}

}  // namespace

// x: float32 planes, plane p at x + p * x_plane, L contiguous samples each;
// g2: float32 [2C, K*2D] contiguous; o_re, o_im: float32 [C, nb]; i_re,
// i_im: float32 [C, tile]; out: float32 [C, 2, n_out] contiguous, with
// n_out <= nb * tile. All on the calling thread's current CUDA device.
// Launches on `stream` without synchronising and returns the launch's
// cudaError_t.
extern "C" int fused_chan_launch(const void* x, long long x_plane, long long L,
                                 const void* g2, int C, int D, int K,
                                 const void* o_re, const void* o_im, long long nb,
                                 const void* i_re, const void* i_im, int tile,
                                 void* out, long long n_out, void* stream) {
  if (C < 1 || D < 1 || K < 1 || tile < 1 || L < 1 || n_out < 1 || nb * tile < n_out)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = (n_out + kT - 1) / kT;
  const int64_t groups = (C + kCh - 1) / kCh;
  if (tiles > 0x7fffffffLL || groups > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, (unsigned)groups);
  fused_chan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), x_plane, L, static_cast<const float*>(g2), C, D, K,
      static_cast<const float*>(o_re), static_cast<const float*>(o_im), nb,
      static_cast<const float*>(i_re), static_cast<const float*>(i_im), tile,
      static_cast<float*>(out), n_out);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_chan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
