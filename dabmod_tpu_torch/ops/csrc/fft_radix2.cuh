// Radix-2 transform stages in shared memory, shared by the OFDM kernels
// (ofdm_ifft.cu, ofdm_cfr.cu).
//
// A block transforms one N-point complex symbol held in a shared float2
// buffer, N = 2^log2n.  `twiddle` holds exp(+2*pi*i*m/N) for m < N/2 in
// float32 (computed on the host in float64); the forward stages use its
// conjugates.  Every stage ends with a block-wide barrier, so the caller
// needs none after a call.
//
//   dit_inverse_stages: decimation in time, bit-reversed order in, natural
//       order out; the unnormalised backward DFT (FFTW_BACKWARD).
//   dif_forward_stages: decimation in frequency, natural order in,
//       bit-reversed order out; the unnormalised forward DFT (FFTW_FORWARD).
//
// Used as a pair, the forward transform hands its bins to the inverse one
// in the order it takes them: no reorder between the two.
#pragma once

#include <cuda_runtime.h>

namespace dabmod {

__device__ __forceinline__ int bitrev_index(int k, int log2n) {
  return static_cast<int>(__brev(static_cast<unsigned>(k)) >> (32 - log2n));
}

__device__ __forceinline__ void dit_inverse_stages(
    float2* buf, const float2* __restrict__ twiddle, int log2n) {
  const int half_n = 1 << (log2n - 1);
  for (int s = 0; s < log2n; ++s) {
    const int h = 1 << s;              // half the size of this stage's groups
    const int tw_step = half_n >> s;   // N / (2h)
    for (int b = threadIdx.x; b < half_n; b += blockDim.x) {
      const int j = b & (h - 1);
      const int i0 = ((b >> s) << (s + 1)) + j;
      const int i1 = i0 + h;
      const float2 w = twiddle[j * tw_step];
      const float2 a = buf[i0];
      const float2 c = buf[i1];
      const float tr = c.x * w.x - c.y * w.y;
      const float ti = c.x * w.y + c.y * w.x;
      buf[i0] = make_float2(a.x + tr, a.y + ti);
      buf[i1] = make_float2(a.x - tr, a.y - ti);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void dif_forward_stages(
    float2* buf, const float2* __restrict__ twiddle, int log2n) {
  const int half_n = 1 << (log2n - 1);
  for (int s = log2n - 1; s >= 0; --s) {
    const int h = 1 << s;
    const int tw_step = half_n >> s;
    for (int b = threadIdx.x; b < half_n; b += blockDim.x) {
      const int j = b & (h - 1);
      const int i0 = ((b >> s) << (s + 1)) + j;
      const int i1 = i0 + h;
      const float2 w = twiddle[j * tw_step];   // conj(w) = exp(-2*pi*i*...)
      const float2 a = buf[i0];
      const float2 c = buf[i1];
      const float dr = a.x - c.x;
      const float di = a.y - c.y;
      buf[i0] = make_float2(a.x + c.x, a.y + c.y);
      buf[i1] = make_float2(dr * w.x + di * w.y, di * w.x - dr * w.y);
    }
    __syncthreads();
  }
}

}  // namespace dabmod
