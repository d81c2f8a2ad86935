// OFDM IFFT + crest factor reduction + per-symbol statistics, for Hopper
// (sm_90a).
//
// Replaces dabmod_tpu/ops/ofdm_kernel.py::build_ofdm_backend with
// enable_cfr=True and carrier_map set (the Pallas kernel body at :265-320).
// For every OFDM symbol, on (re, im) float32 planes, with the bins B taken
// from the carriers by the same composed gather as ofdm_ifft.cu:
//
//   x   = IFFT(B)                                   (FFTW_BACKWARD)
//   c   = x scaled to |c| <= clip                   (per sample)
//   S   = FFT(c) / N                                (FFTW_FORWARD)
//   e   = B - S, scaled to |e| <= error_clip        (per bin)
//   out = IFFT(S + e)
//
// and eight statistics lanes per symbol (dabmod_tpu's ST_* order):
// the clip count, the error-clip count, sum |x|^2, max |x|^2, sum |out|^2,
// max |out|^2, sum |out - x|^2 (the MER denominator) and 0.
//
// What bounds it on the H100: device memory, nearly tied with arithmetic.
// At TM I with batch_tf=24 (1848 symbols, C = 1536, N = 2048) it must read
// 22.7 MB of carriers and write 30.3 MB of samples and 59 KB of statistics:
// 53.1 MB, 15.8 us at 3.35 TB/s.  Three transforms of 5 N log2(N) flop plus
// the clips and sums are about 0.7 GFLOP, 10-11 us at the 67 TFLOP/s fp32
// (non-tensor) peak.
//
// What the design does about it: everything between the carrier read and
// the sample write stays in shared memory.  One thread block per symbol
// reads the carriers coalesced, gathers them into bit-reversed bin order
// (kept as B), and runs the three transforms in place on a working buffer
// with the radix-2 stages of fft_radix2.cuh: DIT inverse (bit-reversed in,
// natural out), clip, DIF forward (natural in, bit-reversed out, the order
// B is kept in, so e = B - S/N needs no reorder), DIT inverse.  x is kept
// for the MER denominator.  Three N-point buffers are 48 KB at N = 2048,
// above the 48 KB of static shared memory once the reduction scratch is
// added, so they are dynamic shared memory (the carriers, read before x
// exists, share x's buffer).
//
// Numerics follow dabmod_tpu's arithmetic: |v|^2 = re*re + im*im and the
// error update S + e*scale are rounded after every operation (no fused
// multiply-add), the thresholds clip^2 and error_clip^2 come from the host
// already rounded to float32, and the scale is sqrt(limit^2 / |v|^2) with
// IEEE division and square root.  Sums and maxima are fp32; the counts are
// exact below 2^24.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_radix2.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kReduced = 7;          // statistics lanes 0..6; lane 7 is 0
constexpr int kStats = 8;

__device__ __forceinline__ float mag2(float r, float i) {
  return __fadd_rn(__fmul_rn(r, r), __fmul_rn(i, i));
}

// The factor that brings a sample of squared magnitude m2 back onto the
// limit (limit2 = limit^2); 1 for samples at or under it.
__device__ __forceinline__ float clip_scale(float m2, float limit2,
                                            int* count) {
  if (m2 > limit2) {
    ++*count;
    return sqrtf(limit2 / (m2 > 0.f ? m2 : 1.f));
  }
  return 1.f;
}

__global__ void __launch_bounds__(kThreads)
ofdm_cfr_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const int32_t* __restrict__ src,
                const float* __restrict__ valid,
                const float2* __restrict__ twiddle,
                float* __restrict__ yr, float* __restrict__ yi,
                float* __restrict__ stats, int n_carriers, int log2n,
                float clip2, float error_clip2) {
  extern __shared__ float2 smem[];
  __shared__ float red[kWarps][kReduced];

  const int n = 1 << log2n;
  float2* bins = smem;            // B, bit-reversed order
  float2* xs = smem + n;          // x, natural order
  float2* work = smem + 2 * n;
  float* car_r = reinterpret_cast<float*>(xs);   // until x is written
  float* car_i = car_r + n_carriers;
  const size_t sym = blockIdx.x;

  // 1. this symbol's carriers, coalesced
  const float* pr = xr + sym * n_carriers;
  const float* pi = xi + sym * n_carriers;
  for (int c = threadIdx.x; c < n_carriers; c += blockDim.x) {
    car_r[c] = pr[c];
    car_i[c] = pi[c];
  }
  __syncthreads();

  // 2. composed gather into bit-reversed order, kept as B
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    float2 v = make_float2(0.f, 0.f);
    if (valid[k] != 0.f) {
      const int s = src[k];
      v = make_float2(car_r[s], car_i[s]);
    }
    const int r = dabmod::bitrev_index(k, log2n);
    bins[r] = v;
    work[r] = v;
  }
  __syncthreads();

  // 3. x = IFFT(B), natural order
  dabmod::dit_inverse_stages(work, twiddle, log2n);

  // 4. keep x, its statistics, and clip it in place
  int n_clip = 0;
  float pow_before = 0.f, peak_before = 0.f;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float2 v = work[k];
    xs[k] = v;
    const float m2 = mag2(v.x, v.y);
    pow_before += m2;
    peak_before = fmaxf(peak_before, m2);
    const float s = clip_scale(m2, clip2, &n_clip);
    work[k] = make_float2(__fmul_rn(v.x, s), __fmul_rn(v.y, s));
  }
  __syncthreads();

  // 5. S = FFT(c) / N in bit-reversed order; error against B, clipped
  dabmod::dif_forward_stages(work, twiddle, log2n);
  const float inv_n = 1.f / static_cast<float>(n);     // exact: N = 2^k
  int n_err = 0;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float2 v = work[k];
    const float2 b = bins[k];
    const float sr = __fmul_rn(v.x, inv_n);
    const float si = __fmul_rn(v.y, inv_n);
    const float er = __fsub_rn(b.x, sr);
    const float ei = __fsub_rn(b.y, si);
    const float s = clip_scale(mag2(er, ei), error_clip2, &n_err);
    work[k] = make_float2(__fadd_rn(sr, __fmul_rn(er, s)),
                          __fadd_rn(si, __fmul_rn(ei, s)));
  }
  __syncthreads();

  // 6. out = IFFT(S + e)
  dabmod::dit_inverse_stages(work, twiddle, log2n);

  // 7. natural-order samples, coalesced, with their statistics
  float* qr = yr + sym * n;
  float* qi = yi + sym * n;
  float pow_after = 0.f, peak_after = 0.f, mer_den = 0.f;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float2 v = work[k];
    const float2 x = xs[k];
    qr[k] = v.x;
    qi[k] = v.y;
    const float m2 = mag2(v.x, v.y);
    pow_after += m2;
    peak_after = fmaxf(peak_after, m2);
    mer_den += mag2(__fsub_rn(v.x, x.x), __fsub_rn(v.y, x.y));
  }

  // 8. block reduction: sums, except the two maxima (lanes 3 and 5)
  float vals[kReduced] = {static_cast<float>(n_clip),
                          static_cast<float>(n_err), pow_before, peak_before,
                          pow_after, peak_after, mer_den};
#pragma unroll
  for (int i = 0; i < kReduced; ++i) {
    const bool is_max = (i == 3 || i == 5);
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_down_sync(0xffffffffu, vals[i], off);
      vals[i] = is_max ? fmaxf(vals[i], o) : vals[i] + o;
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < kReduced; ++i) red[warp][i] = vals[i];
  }
  __syncthreads();
  if (threadIdx.x < kStats) {
    const int i = threadIdx.x;
    float acc = 0.f;
    if (i < kReduced) {
      const bool is_max = (i == 3 || i == 5);
      acc = red[0][i];
      for (int w = 1; w < kWarps; ++w)
        acc = is_max ? fmaxf(acc, red[w][i]) : acc + red[w][i];
    }
    stats[sym * kStats + i] = acc;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t).  The caller checks every argument:
// n_symbols >= 1, 1 <= n_carriers <= 2^log2n, 2 <= log2n <= 11, every src
// entry in [0, n_carriers), all buffers on the current device.  clip2 and
// error_clip2 are the squared limits rounded to float32.  Returns the CUDA
// error of the shared-memory attribute or of the launch (0 = launched).
extern "C" int dabmod_ofdm_cfr(const void* xr, const void* xi,
                               const void* src, const void* valid,
                               const void* twiddle, void* yr, void* yi,
                               void* stats, long long n_symbols,
                               int n_carriers, int log2n, float clip2,
                               float error_clip2, void* stream) {
  // above 48 KB only after the attribute is raised (per device: set on
  // every launch, a host-side call that queues nothing)
  const int smem = 3 * (1 << log2n) * static_cast<int>(sizeof(float2));
  const cudaError_t e = cudaFuncSetAttribute(
      ofdm_cfr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ofdm_cfr_kernel<<<static_cast<unsigned>(n_symbols), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const int32_t*>(src), static_cast<const float*>(valid),
      static_cast<const float2*>(twiddle), static_cast<float*>(yr),
      static_cast<float*>(yi), static_cast<float*>(stats), n_carriers, log2n,
      clip2, error_clip2);
  return static_cast<int>(cudaGetLastError());
}
