// Polyphase L/M resampler for Hopper (sm_90a).
//
// Replaces dabmod_tpu/ops/resampler_kernel.py::build_resampler_backend (the
// Pallas kernel that multiplies the framed stream by the banded operator
// of a PolyphasePlan with block = 128).  On (re, im) float32 planes, with
// xp = concat(carry, x) (the carry is the 2*half input samples before x),
// the output stream is
//
//   y[q*L + p] = sum_{k < K} xp[q*M + row0[p] + k] * taps[p, k]
//
// for output phase p < L: taps[p] is the band of the operator's column p
// (its non-zero rows start at row0[p]), and column q*L + p of a frame is
// column p moved down by q*M rows.  The wrapper extracts the table from
// the plan's operator and checks that it rebuilds every entry of it bit
// for bit, so these are the plan's own coefficients.  y lags x by `half`
// samples, as the framed product does.
//
// What bounds it on the H100: device memory.  At 8.192 MS/s (L = 4, M = 1,
// half = 16, K = 33) and batch_tf = 24 (4,718,592 samples a plane) it must
// read 37.7 MB and write 151.0 MB: 188.7 MB, 56 us at 3.35 TB/s.  The band
// is 33 of the operator's 160 rows: 2.49 GFLOP, 37 us at the 67 TFLOP/s
// fp32 (non-tensor) peak.  The TPU's dense form (two K = 128 products per
// frame) would do 19 GFLOP; it is a shape chosen for the MXU and is not
// carried over.
//
// What the design does about it: each input sample is read from device
// memory about once and each output written once.  A block produces
// `q_per_block` * L consecutive outputs of both planes: it stages the
// input run they need (plus the band's overhang) and the tap table in
// shared memory, reading the carry through its own pointer where the run
// starts before x, so the wrapper never concatenates the stream.  Each
// thread then computes whole outputs from shared memory (fp32 fused
// multiply-adds over the band) and the block writes them coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
resample_poly_kernel(const float* __restrict__ xr,
                     const float* __restrict__ xi,
                     const float* __restrict__ carry_r,
                     const float* __restrict__ carry_i,
                     const int32_t* __restrict__ row0,
                     const float* __restrict__ taps,
                     float* __restrict__ yr, float* __restrict__ yi,
                     long long n_in, int h2, int L, int M, int K,
                     int q_per_block, int span) {
  extern __shared__ float smem[];
  float* s_taps = smem;                                   // [L * K]
  int* s_row0 = reinterpret_cast<int*>(s_taps + L * K);   // [L]
  float* s_r = reinterpret_cast<float*>(s_row0 + L);      // [span]
  float* s_i = s_r + span;                                // [span]

  const long long n_q = n_in / M;                // output groups of L
  const long long q0 = static_cast<long long>(blockIdx.x) * q_per_block;
  const long long in0 = q0 * M;                  // index into xp
  const long long n_xp = n_in + h2;

  for (int t = threadIdx.x; t < L * K; t += blockDim.x) s_taps[t] = taps[t];
  for (int t = threadIdx.x; t < L; t += blockDim.x) s_row0[t] = row0[t];
  for (int t = threadIdx.x; t < span; t += blockDim.x) {
    const long long g = in0 + t;
    float vr = 0.f, vi = 0.f;             // beyond the stream: zero taps
    if (g < h2) {
      vr = carry_r[g];
      vi = carry_i[g];
    } else if (g < n_xp) {
      vr = xr[g - h2];
      vi = xi[g - h2];
    }
    s_r[t] = vr;
    s_i[t] = vi;
  }
  __syncthreads();

  const long long q_left = n_q - q0;
  const int n_out =
      static_cast<int>(q_left < q_per_block ? q_left : q_per_block) * L;
  float* out_r = yr + q0 * L;
  float* out_i = yi + q0 * L;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    const int q = o / L;
    const int p = o - q * L;
    const int base = q * M + s_row0[p];
    const float* t = s_taps + p * K;
    float acc_r = 0.f, acc_i = 0.f;
    for (int k = 0; k < K; ++k) {
      acc_r = fmaf(s_r[base + k], t[k], acc_r);
      acc_i = fmaf(s_i[base + k], t[k], acc_i);
    }
    out_r[o] = acc_r;
    out_i[o] = acc_i;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t).  The caller checks every argument:
// n_in > 0 a multiple of M, 0 < h2, 1 <= L, 1 <= M, 1 <= K, every row0
// entry in [0, span - K - (q_per_block - 1) * M], span the staged run
// length, smem_bytes the kernel's carve-up above, (L*K + L + 2*span) * 4,
// at most 48 KB (resampler_kernel.make_table), all buffers on the current
// device.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dabmod_resample_poly(const void* xr, const void* xi,
                                    const void* carry_r, const void* carry_i,
                                    const void* row0, const void* taps,
                                    void* yr, void* yi, long long n_in,
                                    int h2, int L, int M, int K,
                                    int q_per_block, int span, int smem_bytes,
                                    void* stream) {
  const long long n_q = n_in / M;
  const long long blocks = (n_q + q_per_block - 1) / q_per_block;
  resample_poly_kernel<<<static_cast<unsigned>(blocks), kThreads,
                         static_cast<size_t>(smem_bytes),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(carry_r), static_cast<const float*>(carry_i),
      static_cast<const int32_t*>(row0), static_cast<const float*>(taps),
      static_cast<float*>(yr), static_cast<float*>(yi), n_in, h2, L, M, K,
      q_per_block, span);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape on the current device at smem_bytes of dynamic shared
// memory: out[0] threads a block, out[1] resident blocks an SM by the CUDA
// runtime's occupancy calculator.  Returns the CUDA error code (0 =
// success).
extern "C" int dabmod_resample_poly_shape(int smem_bytes, int* out) {
  out[0] = kThreads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], resample_poly_kernel, kThreads,
      static_cast<size_t>(smem_bytes)));
}
