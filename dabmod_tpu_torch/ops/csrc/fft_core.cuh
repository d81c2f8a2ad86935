// The register-resident FFT core shared by the OFDM kernels (ofdm_ifft.cu,
// ofdm_cfr.cu): N-point complex transforms, N in {256, 512, 1024, 2048},
// for Hopper (sm_90a).
//
// Layout.  A block of kBlockThreads = 128 threads carries SPB = 2048 / N
// symbols; thread tid works on symbol ls = tid / TS of the block as its
// t = tid % TS, TS = N / 16 threads a symbol.  Each thread holds kPoints =
// 16 complex points of its symbol in registers, point m at index t + TS*m:
//
//   inverse(v): v[m] = X[t + TS*m] (natural-order bins) in,
//               v[m] = x[t + TS*m] = sum_k X[k] exp(+2*pi*i*k*n/N) out
//               (the unnormalised backward DFT, FFTW_BACKWARD);
//   forward(v): v[m] = x[t + TS*m] in, v[m] = sum_n x[n] exp(-2*pi*i*k*n/N)
//               at k = t + TS*m out (FFTW_FORWARD).
//
// So a warp-wide load or store of one m is TS contiguous floats in each
// plane, and the forward transform leaves bin k in the register that held
// bin k before the inverse one: elementwise work between transforms (the
// CFR's clip and its error against the bins) stays in registers.
//
// Passes (Stockham, self-sorting: no bit reversal anywhere).  N = R0*16*16
// with R0 = N/256 in {1, 2, 4, 8}.  In Stockham form a pass of radix R on
// sub-transforms of length p (virtual thread i of N/R, k = i mod p) reads
// u[r] = y[i + r*N/R], multiplies u[r] by exp(+2*pi*i*r*k/(p*R)), runs an
// R-point DFT and writes u[r] to y'[(i/p)*p*R + k + r*p]:
//
//   pass 0: radix R0, p = 1, no twiddles; each thread runs 16/R0 butterflies
//           on its registers v[b + r*16/R0] (virtual thread t + b*TS) and
//           writes exchange 1 at (t + b*TS)*R0 + r;
//   pass 1: radix 16, p = R0: reads exchange 1 at t + r*TS, twiddles
//           tw[r*R0 + k], k = t mod R0 (table part 1), writes exchange 2 at
//           (t/R0)*16*R0 + k + r*R0;
//   pass 2: radix 16, p = N/16: reads exchange 2 at t + r*TS, twiddles
//           tw[16*R0 + r*TS + t] (table part 2), and its output stays in
//           registers: v[r] = x[t + r*TS].
//
// At N = 256 (R0 = 1) pass 0 and exchange 1 drop out: the bins already sit
// where pass 1 reads them.  Two exchanges through shared memory per
// transform (one at N = 256).
// The forward transform is the exact transpose of the inverse one: the same
// passes in reverse order, each transposed (the DFT and the twiddles are
// symmetric, so a pass's reads become its writes), with conjugate twiddles.
//
// Radix-16 and radix-8 butterflies run in registers as 4x4 and 4x2 steps;
// their internal twiddles are compile-time constants.  The inter-pass
// twiddles exp(+2*pi*i*m/M) come from a table built on the host in float64
// and rounded once to float32, laid out as the passes read them (part 1
// [16][R0], then part 2 [16][N/16]: a warp reads contiguous entries) and
// read through __ldg (at most 17 KB, which stays in L1).  No __sinf/__cosf.
//
// Exchanges and banks.  The exchange buffer holds the block's symbols as
// two float planes (re, im), STRIDE = N + N/16 floats a symbol.  Index a
// of a symbol is stored at a padded slot:
//
//   exchange 1: a + a/32            (one pad float every 32)
//   exchange 2: a + (a/TS)*R0       (R0 pad floats every TS = 16*R0)
//
// No access of a pass carries across a pad boundary, so each is a
// per-thread base plus a compile-time offset: a thread computes one base
// a pass and its 16 loads or stores take immediate offsets, where an
// address computed for each access would cost more integer instructions
// than the butterflies cost floating-point ones:
//
//   pass 0 write  a = t*R0 + b*TS*R0 + r
//                 slot pad1(t*R0) + pad1(b*TS*R0) + r
//   pass 1 read   a = t + r*TS
//                 slot pad1(t) + pad1(r*TS)
//   pass 1 write  a = (t/R0)*TS + t%R0 + r*R0
//                 slot (t/R0)*(TS + R0) + t%R0 + r*R0
//   pass 2 read   a = t + r*TS
//                 slot t + r*(TS + R0)
//
// A warp's 32 accesses of one (b, r) then hit 32 distinct banks at all
// four N.  At N = 2048, for lane l (t = 32w + l): pass 0 writes 8t + t/4 +
// const, 8*(l%4) + l/4 mod 32; pass 1 reads l + w + const; pass 1 writes
// 136*(t/8) + t%8 + const, 8*(l/8) + l%8 mod 32; pass 2 reads l + const.
// At N = 256 a warp carries two symbols of 16 threads, and STRIDE = 272,
// 16 mod 32, puts the second on the banks the first leaves free.
// tests/test_torch_ofdm_kernel.py checks the decomposition and the banks
// of every access of the schedule.
#pragma once

#include <cuda_runtime.h>

namespace dabmod {

constexpr int kBlockThreads = 128;
constexpr int kPoints = 16;        // complex points a thread holds

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// a * w (INV) or a * conj(w) (forward)
template <bool INV>
__device__ __forceinline__ float2 ctwiddle(float2 a, float2 w) {
  return INV ? make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x)
             : make_float2(a.x * w.x + a.y * w.y, a.y * w.x - a.x * w.y);
}

// a * (c + i*s) for the inverse direction, a * (c - i*s) for the forward
template <bool INV>
__device__ __forceinline__ float2 crot(float2 a, float c, float s) {
  return ctwiddle<INV>(a, make_float2(c, s));
}

// a * (+i) for the inverse direction, a * (-i) for the forward
template <bool INV>
__device__ __forceinline__ float2 crot90(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

template <bool INV>
__device__ __forceinline__ void dft2(float2& a0, float2& a1) {
  const float2 s = cadd(a0, a1);
  a1 = csub(a0, a1);
  a0 = s;
}

template <bool INV>
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 s02 = cadd(a0, a2), d02 = csub(a0, a2);
  const float2 s13 = cadd(a1, a3), d13 = crot90<INV>(csub(a1, a3));
  a0 = cadd(s02, s13);
  a2 = csub(s02, s13);
  a1 = cadd(d02, d13);
  a3 = csub(d02, d13);
}

constexpr float kC1 = 0.92387953251128674f;   // cos(pi/8)
constexpr float kS1 = 0.38268343236508977f;   // sin(pi/8)
constexpr float kR2 = 0.70710678118654752f;   // sqrt(1/2)

// 8-point DFT in natural order: r = 2*r1 + r2, s = s1 + 4*s2; four-point
// DFTs over r1, twiddles w8^(r2*s1), two-point DFTs over r2.
template <bool INV>
__device__ __forceinline__ void dft8(float2 (&v)[8]) {
  dft4<INV>(v[0], v[2], v[4], v[6]);
  dft4<INV>(v[1], v[3], v[5], v[7]);
  v[3] = crot<INV>(v[3], kR2, kR2);
  v[5] = crot90<INV>(v[5]);
  v[7] = crot<INV>(v[7], -kR2, kR2);
  dft2<INV>(v[0], v[1]);
  dft2<INV>(v[2], v[3]);
  dft2<INV>(v[4], v[5]);
  dft2<INV>(v[6], v[7]);
  // U[s1 + 4*s2] sits at v[2*s1 + s2]
  const float2 t1 = v[1], t2 = v[2], t3 = v[3], t4 = v[4], t5 = v[5],
               t6 = v[6];
  v[1] = t2; v[2] = t4; v[3] = t6; v[4] = t1; v[5] = t3; v[6] = t5;
}

// 16-point DFT in natural order: r = 4*r1 + r2, s = s1 + 4*s2; four-point
// DFTs over r1, twiddles w16^(r2*s1), four-point DFTs over r2.
template <bool INV>
__device__ __forceinline__ void dft16(float2 (&v)[kPoints]) {
#pragma unroll
  for (int r2 = 0; r2 < 4; ++r2) dft4<INV>(v[r2], v[4 + r2], v[8 + r2], v[12 + r2]);
  // A[r2][s1] sits at v[4*s1 + r2]
  v[5] = crot<INV>(v[5], kC1, kS1);       // w^1
  v[6] = crot<INV>(v[6], kR2, kR2);       // w^2
  v[7] = crot<INV>(v[7], kS1, kC1);       // w^3
  v[9] = crot<INV>(v[9], kR2, kR2);       // w^2
  v[10] = crot90<INV>(v[10]);             // w^4
  v[11] = crot<INV>(v[11], -kR2, kR2);    // w^6
  v[13] = crot<INV>(v[13], kS1, kC1);     // w^3
  v[14] = crot<INV>(v[14], -kR2, kR2);    // w^6
  v[15] = crot<INV>(v[15], -kC1, -kS1);   // w^9
#pragma unroll
  for (int s1 = 0; s1 < 4; ++s1)
    dft4<INV>(v[4 * s1], v[4 * s1 + 1], v[4 * s1 + 2], v[4 * s1 + 3]);
  // U[s1 + 4*s2] sits at v[4*s1 + s2]: a 4x4 transpose of the registers
  float2 u[kPoints];
#pragma unroll
  for (int s = 0; s < kPoints; ++s) u[s] = v[4 * (s & 3) + (s >> 2)];
#pragma unroll
  for (int s = 0; s < kPoints; ++s) v[s] = u[s];
}

template <int R, bool INV>
__device__ __forceinline__ void dft_small(float2 (&u)[R]) {
  if constexpr (R == 2) {
    dft2<INV>(u[0], u[1]);
  } else if constexpr (R == 4) {
    dft4<INV>(u[0], u[1], u[2], u[3]);
  } else {
    static_assert(R == 8, "pass 0 has radix 2, 4 or 8");
    dft8<INV>(u);
  }
}

template <int LOG2N>
struct FftCore {
  static_assert(LOG2N >= 8 && LOG2N <= 11, "N in {256, 512, 1024, 2048}");
  static constexpr int N = 1 << LOG2N;
  static constexpr int TS = N / kPoints;              // threads a symbol
  static constexpr int SPB = kBlockThreads / TS;      // symbols a block
  static constexpr int R0 = N / 256;                  // pass 0's radix
  static constexpr int G0 = kPoints / R0;             // pass 0's butterflies
  static constexpr int STRIDE = N + N / 16;           // floats a symbol
  static constexpr int kExchangeFloats = 2 * SPB * STRIDE;
  static constexpr int kTw2 = kPoints * R0;           // table part 2
  // the carrier buffer of the kernels: two planes of SPB symbols, each at
  // most 3N/4 carriers (make_table's limit) and the zero slot after them
  static constexpr int kCarrierStride = 3 * N / 4 + 4;
  static constexpr int kCarrierFloats = 2 * SPB * kCarrierStride;

  __host__ __device__ static constexpr int pad1(int a) { return a + (a >> 5); }

  // v[m] = X[t + TS*m] -> v[m] = x[t + TS*m].  `ex` is the block's
  // exchange buffer (kExchangeFloats); it may alias what the block read
  // before the call (the call starts with a barrier), and after the call
  // every thread has read its last value from it.
  __device__ static __forceinline__ void inverse(
      float2 (&v)[kPoints], float* ex, int ls, int t,
      const float2* __restrict__ tw) {
    float* er = ex + ls * STRIDE;
    float* ei = er + SPB * STRIDE;
    __syncthreads();
    if constexpr (R0 > 1) {
      const int w1 = pad1(t * R0);
#pragma unroll
      for (int b = 0; b < G0; ++b) {
        float2 u[R0];
#pragma unroll
        for (int r = 0; r < R0; ++r) u[r] = v[b + r * G0];
        dft_small<R0, true>(u);
#pragma unroll
        for (int r = 0; r < R0; ++r) {
          const int a = w1 + pad1(b * TS * R0) + r;
          er[a] = u[r].x;
          ei[a] = u[r].y;
        }
      }
      __syncthreads();
      const int r1 = pad1(t);
#pragma unroll
      for (int r = 0; r < kPoints; ++r) {
        const int a = r1 + pad1(r * TS);
        v[r] = make_float2(er[a], ei[a]);
      }
      __syncthreads();     // exchange 2 reuses the buffer
      const float2* tw1 = tw + (t & (R0 - 1));
#pragma unroll
      for (int r = 1; r < kPoints; ++r)
        v[r] = ctwiddle<true>(v[r], __ldg(&tw1[r * R0]));
    }
    dft16<true>(v);
    const int w2 = (t / R0) * (TS + R0) + (t & (R0 - 1));
#pragma unroll
    for (int r = 0; r < kPoints; ++r) {
      er[w2 + r * R0] = v[r].x;
      ei[w2 + r * R0] = v[r].y;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kPoints; ++r)
      v[r] = make_float2(er[t + r * (TS + R0)], ei[t + r * (TS + R0)]);
    const float2* tw2 = tw + kTw2 + t;
#pragma unroll
    for (int r = 1; r < kPoints; ++r)
      v[r] = ctwiddle<true>(v[r], __ldg(&tw2[r * TS]));
    dft16<true>(v);
  }

  // v[m] = x[t + TS*m] -> v[m] = X[t + TS*m]: inverse() transposed, with
  // conjugate twiddles.  The same contract on `ex`.
  __device__ static __forceinline__ void forward(
      float2 (&v)[kPoints], float* ex, int ls, int t,
      const float2* __restrict__ tw) {
    float* er = ex + ls * STRIDE;
    float* ei = er + SPB * STRIDE;
    __syncthreads();
    dft16<false>(v);
    const float2* tw2 = tw + kTw2 + t;
#pragma unroll
    for (int r = 1; r < kPoints; ++r)
      v[r] = ctwiddle<false>(v[r], __ldg(&tw2[r * TS]));
#pragma unroll
    for (int r = 0; r < kPoints; ++r) {
      er[t + r * (TS + R0)] = v[r].x;
      ei[t + r * (TS + R0)] = v[r].y;
    }
    __syncthreads();
    const int w2 = (t / R0) * (TS + R0) + (t & (R0 - 1));
#pragma unroll
    for (int r = 0; r < kPoints; ++r)
      v[r] = make_float2(er[w2 + r * R0], ei[w2 + r * R0]);
    dft16<false>(v);
    if constexpr (R0 > 1) {
      const float2* tw1 = tw + (t & (R0 - 1));
#pragma unroll
      for (int r = 1; r < kPoints; ++r)
        v[r] = ctwiddle<false>(v[r], __ldg(&tw1[r * R0]));
      __syncthreads();     // exchange 1 reuses the buffer
      const int r1 = pad1(t);
#pragma unroll
      for (int r = 0; r < kPoints; ++r) {
        const int a = r1 + pad1(r * TS);
        er[a] = v[r].x;
        ei[a] = v[r].y;
      }
      __syncthreads();
      const int w1 = pad1(t * R0);
#pragma unroll
      for (int b = 0; b < G0; ++b) {
        float2 u[R0];
#pragma unroll
        for (int r = 0; r < R0; ++r) {
          const int a = w1 + pad1(b * TS * R0) + r;
          u[r] = make_float2(er[a], ei[a]);
        }
        dft_small<R0, false>(u);
#pragma unroll
        for (int r = 0; r < R0; ++r) v[b + r * G0] = u[r];
      }
    }
  }
};

// The carriers of symbol `sym`, when it is below n_symbols, into cr[0, c)
// and ci[0, c), by the symbol's TS threads t; and the zero slot cr[c] =
// ci[c] = 0, where the gather table sends the empty bins.  16-byte loads
// and stores where the planes allow them (c a multiple of 4, planes
// 16-byte aligned; cr and ci are), 4-byte ones otherwise.  The caller
// synchronises before reading the buffer.
template <int TS>
__device__ __forceinline__ void load_carriers(
    const float* __restrict__ xr, const float* __restrict__ xi, float* cr,
    float* ci, long long sym, long long n_symbols, int c, int t) {
  if (t == 0) {
    cr[c] = 0.f;
    ci[c] = 0.f;
  }
  if (sym >= n_symbols) return;
  const float* pr = xr + sym * c;
  const float* pi = xi + sym * c;
  const bool vec = (c & 3) == 0 &&
      ((reinterpret_cast<size_t>(xr) | reinterpret_cast<size_t>(xi)) & 15) == 0;
  if (vec) {
    for (int e = 4 * t; e < c; e += 4 * TS) {
      *reinterpret_cast<float4*>(cr + e) =
          __ldg(reinterpret_cast<const float4*>(pr + e));
      *reinterpret_cast<float4*>(ci + e) =
          __ldg(reinterpret_cast<const float4*>(pi + e));
    }
  } else {
    for (int e = t; e < c; e += TS) {
      cr[e] = __ldg(pr + e);
      ci[e] = __ldg(pi + e);
    }
  }
}

}  // namespace dabmod
