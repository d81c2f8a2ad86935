// OFDM IFFT + crest factor reduction + per-symbol statistics, for Hopper
// (sm_90a).
//
// Replaces dabmod_tpu/ops/ofdm_kernel.py::build_ofdm_backend with
// enable_cfr=True and carrier_map set (the Pallas kernel body at :275-320).
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
// What held the earlier design back (three radix-2 transforms in shared
// memory, one block per symbol: 0.2528 ms, 6.3 % of the bound), and what
// this one does about each cause:
//   1. 33 radix-2 stages, each a shared-memory round trip and a barrier,
//      plus the elementwise passes through shared memory.  Now the three
//      transforms run on the register-resident core of fft_core.cuh (two
//      exchanges each), and the clip, the error update and the statistics
//      are elementwise on the registers: the forward transform is the
//      inverse one transposed, so it leaves S[k] in the register that
//      held B[k], and out[n] lands in the register that held x[n].
//   2. The bit-reversed scatter of the gather (32-way bank conflicts): now
//      each thread gathers its own bins into registers, and the exchanges
//      are padded to be conflict-free.
//   3. A twiddle load per butterfly: now 30 table reads a thread per
//      transform through __ldg, constants inside the radix-16 butterflies.
//   4. 48 KB of dynamic shared memory a block (B, x and a work buffer) and
//      no elementwise step in registers.  Now the work points live in
//      registers.  B and x do not: keeping them in registers as well (3 x
//      16 complex a thread) spilled at up to 168 registers a thread, so B
//      is gathered again from the carrier buffer for the error, and x is
//      kept in shared memory, each thread's points at TS*m + t (its own
//      slots: no barrier, no conflict).  Shared memory is the carriers, x
//      and the exchange buffer, 46 KB static: 4 blocks an SM, which
//      __launch_bounds__ asks for (at most 128 registers a thread; no
//      spacing spills at that).
//
// Numerics follow dabmod_tpu's arithmetic: |v|^2 = re*re + im*im and the
// error update S + e*scale are rounded after every operation (no fused
// multiply-add), the thresholds clip^2 and error_clip^2 come from the host
// already rounded to float32, and the scale is sqrt(limit^2 / |v|^2) with
// IEEE division and square root; an all-zero symbol keeps scale 1 (no
// NaN).  Sums and maxima are fp32, reduced per symbol by warp shuffles and
// then across the symbol's warps; the counts are exact below 2^24.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_core.cuh"

namespace {

using dabmod::kBlockThreads;
using dabmod::kPoints;

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

template <int LOG2N>
__global__ void __launch_bounds__(kBlockThreads, 4)
ofdm_cfr_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const int32_t* __restrict__ gather,
                const float2* __restrict__ twiddle,
                float* __restrict__ yr, float* __restrict__ yi,
                float* __restrict__ stats, long long n_symbols,
                int n_carriers, float clip2, float error_clip2) {
  using Core = dabmod::FftCore<LOG2N>;
  // lanes that reduce together: a symbol's threads within one warp
  constexpr int kGroup = Core::TS < 32 ? Core::TS : 32;
  constexpr int kGroups = kBlockThreads / kGroup;
  constexpr int kGroupsPerSymbol = Core::TS / kGroup;
  // the carriers (read again for B), x (kept for the MER), the exchange
  __shared__ __align__(16) float car[Core::kCarrierFloats];
  __shared__ float xs[2][Core::SPB * Core::N];
  __shared__ float ex[Core::kExchangeFloats];
  __shared__ float red[kGroups][kReduced];

  const int ls = threadIdx.x / Core::TS;
  const int t = threadIdx.x % Core::TS;
  const long long sym0 = static_cast<long long>(blockIdx.x) * Core::SPB;
  const long long sym = sym0 + ls;

  // 1. each symbol's carriers into shared memory, by its own threads
  float* cr = car + ls * Core::kCarrierStride;
  float* ci = cr + Core::SPB * Core::kCarrierStride;
  dabmod::load_carriers<Core::TS>(xr, xi, cr, ci, sym, n_symbols,
                                  n_carriers, t);
  __syncthreads();

  // 2. B: this thread's bins t + TS*m, into registers
  float2 v[kPoints];
#pragma unroll
  for (int m = 0; m < kPoints; ++m) {
    const int g = __ldg(&gather[t + Core::TS * m]);
    v[m] = make_float2(cr[g], ci[g]);
  }

  // 3. x = IFFT(B), kept in shared memory (point m of thread t at
  // TS*m + t: a warp's store is contiguous); its statistics; the clip
  Core::inverse(v, ex, ls, t, twiddle);
  float* xr_s = xs[0] + ls * Core::N + t;
  float* xi_s = xs[1] + ls * Core::N + t;
  int n_clip = 0;
  float pow_before = 0.f, peak_before = 0.f;
#pragma unroll
  for (int m = 0; m < kPoints; ++m) {
    xr_s[Core::TS * m] = v[m].x;
    xi_s[Core::TS * m] = v[m].y;
    const float m2 = mag2(v[m].x, v[m].y);
    pow_before += m2;
    peak_before = fmaxf(peak_before, m2);
    const float s = clip_scale(m2, clip2, &n_clip);
    v[m] = make_float2(__fmul_rn(v[m].x, s), __fmul_rn(v[m].y, s));
  }

  // 4. S = FFT(c) / N, in the registers that held B; the error against B
  // (gathered again), clipped
  Core::forward(v, ex, ls, t, twiddle);
  const float inv_n = 1.f / static_cast<float>(Core::N);   // exact: 2^-k
  int n_err = 0;
#pragma unroll
  for (int m = 0; m < kPoints; ++m) {
    const float sr = __fmul_rn(v[m].x, inv_n);
    const float si = __fmul_rn(v[m].y, inv_n);
    const int g = __ldg(&gather[t + Core::TS * m]);
    const float er = __fsub_rn(cr[g], sr);
    const float ei = __fsub_rn(ci[g], si);
    const float s = clip_scale(mag2(er, ei), error_clip2, &n_err);
    v[m] = make_float2(__fadd_rn(sr, __fmul_rn(er, s)),
                       __fadd_rn(si, __fmul_rn(ei, s)));
  }

  // 5. out = IFFT(S + e), stored coalesced, with its statistics
  Core::inverse(v, ex, ls, t, twiddle);
  float pow_after = 0.f, peak_after = 0.f, mer_den = 0.f;
#pragma unroll
  for (int m = 0; m < kPoints; ++m) {
    const float m2 = mag2(v[m].x, v[m].y);
    pow_after += m2;
    peak_after = fmaxf(peak_after, m2);
    mer_den += mag2(__fsub_rn(v[m].x, xr_s[Core::TS * m]),
                    __fsub_rn(v[m].y, xi_s[Core::TS * m]));
  }
  if (sym < n_symbols) {
    float* qr = yr + sym * Core::N + t;
    float* qi = yi + sym * Core::N + t;
#pragma unroll
    for (int m = 0; m < kPoints; ++m) {
      qr[Core::TS * m] = v[m].x;
      qi[Core::TS * m] = v[m].y;
    }
  }

  // 6. per-symbol reduction: sums, except the two maxima (lanes 3 and 5);
  // shuffles within a group of kGroup lanes, then across the symbol's
  // groups through shared memory
  float vals[kReduced] = {static_cast<float>(n_clip),
                          static_cast<float>(n_err), pow_before, peak_before,
                          pow_after, peak_after, mer_den};
#pragma unroll
  for (int i = 0; i < kReduced; ++i) {
    const bool is_max = (i == 3 || i == 5);
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, vals[i], off);
      vals[i] = is_max ? fmaxf(vals[i], o) : vals[i] + o;
    }
  }
  if (threadIdx.x % kGroup == 0) {
#pragma unroll
    for (int i = 0; i < kReduced; ++i) red[threadIdx.x / kGroup][i] = vals[i];
  }
  __syncthreads();
  if (threadIdx.x < Core::SPB * kStats) {
    const int s = threadIdx.x / kStats;
    const int i = threadIdx.x % kStats;
    float acc = 0.f;
    if (i < kReduced) {
      const bool is_max = (i == 3 || i == 5);
      acc = red[s * kGroupsPerSymbol][i];
      for (int w = 1; w < kGroupsPerSymbol; ++w) {
        const float o = red[s * kGroupsPerSymbol + w][i];
        acc = is_max ? fmaxf(acc, o) : acc + o;
      }
    }
    if (sym0 + s < n_symbols) stats[(sym0 + s) * kStats + i] = acc;
  }
}

template <int LOG2N>
int launch(const void* xr, const void* xi, const void* gather,
           const void* twiddle, void* yr, void* yi, void* stats,
           long long n_symbols, int n_carriers, float clip2,
           float error_clip2, cudaStream_t stream) {
  constexpr int spb = dabmod::FftCore<LOG2N>::SPB;
  const long long blocks = (n_symbols + spb - 1) / spb;
  ofdm_cfr_kernel<LOG2N><<<static_cast<unsigned>(blocks), kBlockThreads, 0,
                           stream>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const int32_t*>(gather),
      static_cast<const float2*>(twiddle), static_cast<float*>(yr),
      static_cast<float*>(yi), static_cast<float*>(stats), n_symbols,
      n_carriers, clip2, error_clip2);
  return static_cast<int>(cudaGetLastError());
}

template <int LOG2N>
int shape(int* out) {
  out[0] = kBlockThreads;
  out[1] = dabmod::FftCore<LOG2N>::SPB;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], ofdm_cfr_kernel<LOG2N>, kBlockThreads, 0));
}

}  // namespace

// Launch on `stream` (a cudaStream_t).  The caller checks every argument:
// n_symbols >= 1, 1 <= n_carriers <= 3/4 of 2^log2n, 8 <= log2n <= 11,
// every gather entry in [0, n_carriers], the twiddle table of
// ofdm_kernel.make_table, all buffers on the current device.  clip2 and
// error_clip2 are the squared limits rounded to float32.  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for another log2n.
extern "C" int dabmod_ofdm_cfr(const void* xr, const void* xi,
                               const void* gather, const void* twiddle,
                               void* yr, void* yi, void* stats,
                               long long n_symbols, int n_carriers,
                               int log2n, float clip2, float error_clip2,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log2n) {
    case 8: return launch<8>(xr, xi, gather, twiddle, yr, yi, stats, n_symbols, n_carriers, clip2, error_clip2, s);
    case 9: return launch<9>(xr, xi, gather, twiddle, yr, yi, stats, n_symbols, n_carriers, clip2, error_clip2, s);
    case 10: return launch<10>(xr, xi, gather, twiddle, yr, yi, stats, n_symbols, n_carriers, clip2, error_clip2, s);
    case 11: return launch<11>(xr, xi, gather, twiddle, yr, yi, stats, n_symbols, n_carriers, clip2, error_clip2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch shape of the instance for 2^log2n on the current device:
// out[0] threads a block, out[1] symbols a block, out[2] resident blocks an
// SM by the CUDA runtime's occupancy calculator (no dynamic shared memory,
// as launched).  Returns the CUDA error code (0 = success), or
// cudaErrorInvalidValue for another log2n.
extern "C" int dabmod_ofdm_cfr_shape(int log2n, int* out) {
  switch (log2n) {
    case 8: return shape<8>(out);
    case 9: return shape<9>(out);
    case 10: return shape<10>(out);
    case 11: return shape<11>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
