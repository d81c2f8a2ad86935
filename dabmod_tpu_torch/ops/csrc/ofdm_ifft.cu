// OFDM IFFT with the composed carrier gather, for Hopper (sm_90a).
//
// Replaces dabmod_tpu/ops/ofdm_kernel.py::build_ofdm_backend with
// enable_cfr=False and carrier_map set (the Pallas kernel of the TPU
// package's main path).  For every OFDM symbol it computes
//
//   td[s, n] = sum_k bins[s, k] * exp(+2*pi*i*k*n/N)        (FFTW_BACKWARD)
//   bins[s, k] = valid[k] ? sym[s, src[k]] : 0
//
// on (re, im) float32 planes: carrier-order symbols [B*S, C] in, natural
// time order [B*S, N] out, N in {256, 512, 1024, 2048}.  `src` composes
// the carrier->bin placement with the deferred frequency-interleave
// permutation (the modulator's _bin_src_pre); `valid` zeroes the empty
// bins (DC and the guard band).
//
// What bounds it on the H100: device memory.  At TM I with batch_tf=24
// (B*S = 1848 symbols) it must read 1848 x 1536 x 8 B = 22.7 MB of carriers
// and write 1848 x 2048 x 8 B = 30.3 MB of time samples: 53.0 MB, 15.8 us
// at 3.35 TB/s.  The arithmetic is 5 N log2(N) = 112,640 flop per symbol,
// 0.21 GFLOP in all, 3.1 us at the 67 TFLOP/s fp32 (non-tensor) peak.
//
// What the design does about it: one thread block per symbol.  The block
// reads its symbol's carriers once, coalesced, into shared memory, gathers
// them through the index table straight into bit-reversed bin order in a
// second shared buffer (a 2048-point complex symbol is 16 KB), runs an
// iterative radix-2 decimation-in-time transform there, and writes the
// natural-order samples once, coalesced (the stages live in
// fft_radix2.cuh, shared with ofdm_cfr.cu).  The bins never go to device
// memory, so there is no separate gather pass; device memory sees each
// input byte read once and each output byte written once.  The twiddles
// exp(+2*pi*i*m/N), m < N/2, are computed on the host in float64 and stored
// as float32.  All arithmetic is fp32 (no tensor cores).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_radix2.cuh"

namespace {

constexpr int kMaxCarriers = 1536;   // TM I
constexpr int kMaxLog2N = 11;        // N = 2048, TM I
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ofdm_ifft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 const int32_t* __restrict__ src,
                 const float* __restrict__ valid,
                 const float2* __restrict__ twiddle,
                 float* __restrict__ yr, float* __restrict__ yi,
                 int n_carriers, int log2n) {
  __shared__ float car_r[kMaxCarriers];
  __shared__ float car_i[kMaxCarriers];
  __shared__ float2 buf[1 << kMaxLog2N];

  const int n = 1 << log2n;
  const size_t sym = blockIdx.x;

  // 1. this symbol's carriers, coalesced, into shared memory
  const float* pr = xr + sym * n_carriers;
  const float* pi = xi + sym * n_carriers;
  for (int c = threadIdx.x; c < n_carriers; c += blockDim.x) {
    car_r[c] = pr[c];
    car_i[c] = pi[c];
  }
  __syncthreads();

  // 2. composed gather: bin k lands at bit-reversed position bitrev(k)
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    float2 v = make_float2(0.f, 0.f);
    if (valid[k] != 0.f) {
      const int s = src[k];
      v = make_float2(car_r[s], car_i[s]);
    }
    buf[dabmod::bitrev_index(k, log2n)] = v;
  }
  __syncthreads();

  // 3. radix-2 DIT butterflies, in place: bit-reversed in, natural out
  dabmod::dit_inverse_stages(buf, twiddle, log2n);

  // 4. natural-order time samples, coalesced
  float* qr = yr + sym * n;
  float* qi = yi + sym * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float2 v = buf[k];
    qr[k] = v.x;
    qi[k] = v.y;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t).  The caller checks every argument:
// n_symbols >= 1, 1 <= n_carriers <= 1536, 2 <= log2n <= 11, every src
// entry in [0, n_carriers), all buffers on the current device.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dabmod_ofdm_ifft(const void* xr, const void* xi,
                                const void* src, const void* valid,
                                const void* twiddle, void* yr, void* yi,
                                long long n_symbols, int n_carriers,
                                int log2n, void* stream) {
  ofdm_ifft_kernel<<<static_cast<unsigned>(n_symbols), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const int32_t*>(src), static_cast<const float*>(valid),
      static_cast<const float2*>(twiddle), static_cast<float*>(yr),
      static_cast<float*>(yi), n_carriers, log2n);
  return static_cast<int>(cudaGetLastError());
}
