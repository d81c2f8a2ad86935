// The KISS fixed-point inverse transform (K4) for Hopper (sm_90a).
//
// fft_engine=kiss runs upstream's vendored KISS FFT built with
// FIXED_POINT=16 (ODR-DabMod Makefile.am:38, src/OfdmGenerator.cpp:467-579
// OfdmGeneratorFixed).  The TPU package has no Pallas kernel for it: it runs
// dabmod_tpu/ops/kiss_fixed.py::kiss_fft_fixed as int32 XLA ops, and the
// port ran ops/kiss_fixed.py's int32 torch ops on the card, some 1,400
// launches a 24-TF step over [B, 77, 2048] int32 planes.  This kernel does
// the whole transform of a symbol in one block and keeps it in shared
// memory.  For every OFDM symbol it computes, bit for bit as upstream:
//
//   x[j] = rint(sym[s, gather[j]] * 16384), with sym[s, C] = 0   (Q1.14)
//   the kf_work stages on x: radix 2 first where log2(N) is odd, then the
//   radix-4 stages from m = 1 or 2 up to m = N/4 (kf_factor's order)
//
// on float32 carrier planes [B*S, C] (interleaver-input order, as K1 takes
// them).  `gather` composes K1's carrier->bin table (the deferred frequency
// interleave and the bin map) with the input permutation of kf_work's
// recursion, so every stage works in place: stage (p, m) takes the points
// b*p*m + q*m + i, q < p, as one butterfly with the twiddles
// tw[j*i*N/(p*m)].  The butterflies are kf_bfly2 and kf_bfly4 with the
// inverse branch: C_FIXDIV = sround(x * (32767/p)) on every input, C_MUL
// rounding each summed component once, sround(x) = (x + 2^14) >> 15, and a
// wrap to int16 at every store (the kiss_fft_cpx fields are int16_t).
// Twiddles are floor(.5 + 32767*cos/sin), kiss_fixed.twiddles.  Every sum
// stays inside int32: operands are int16 and twiddles at most 32767.
//
// Out: with `words`, the TF's packed s16 wire words (im << 16 | re & 0xFFFF)
// with each symbol's cyclic prefix, the NULL symbol's null_size - N and a
// data symbol's sym_size - N samples (the guard interval with no window
// overlap); else int32 planes [B*S, N] for the windowed guard interval,
// whose Q1.14 window needs the neighbouring symbols.
//
// What bounds it on the H100: device memory.  At TM I with batch_tf=24
// (B*S = 1848 symbols) it must read 1848 x 1536 x 8 B = 22.7 MB of carriers
// and write at least 1848 x 2048 x 4 B = 15.1 MB of int16 pairs: 37.8 MB,
// 11.3 us at 3.35 TB/s.  KISS's arithmetic asks 29 int32 multiplies a point
// (5 a radix-4 stage, 4 the radix-2 one), 110 M in all, 6.6 us at 64 a
// clock an SM (1.67e13/s).  The design:
//   1. One block of 256 threads carries 2048/N symbols, N/8 threads a
//      symbol; a symbol's carriers come in with 16-byte loads into shared
//      memory, which the int32 working set (8 B a point, 16 KB a block)
//      then takes over.
//   2. Each thread gathers 8 consecutive points of KISS's input order into
//      registers, where the deepest stages are whole butterflies: (2, 1) and
//      (4, 2) for odd log2(N), (4, 1) for even.  They run there, and the
//      points go to shared memory as 16-byte stores.
//   3. The other radix-4 stages (three or four) run in place in shared
//      memory, two butterflies a thread a stage, a barrier between stages;
//      twiddles through the read-only cache.
//   4. The wire words, prefix first, go out as coalesced 4-byte stores; the
//      planes as 16-byte ones.
//   5. Four blocks an SM (62 registers a thread, no spill).  Bounds of
//      (256) alone made ptxas hold 40 registers for six blocks and spill
//      16 bytes a thread: 0.0534 ms against 0.0441 ms a 24-TF launch on an
//      H100 80GB HBM3 at 700 W.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // a block
constexpr int kMinBlocks = 4;            // resident an SM: 64 registers at most
constexpr int kPoints = 8;               // points a thread holds (step 2)
constexpr int kSmemInts = 2 * kThreads * kPoints;  // re and im, 16 KB

struct Cx {
  int r, i;
};

__device__ __forceinline__ int wrap16(int x) {
  return static_cast<int16_t>(x);
}

// sround, stored into an int16
__device__ __forceinline__ int sround(int x) {
  return wrap16((x + (1 << 14)) >> 15);
}

// C_FIXDIV with k = SAMP_MAX / radix
__device__ __forceinline__ Cx fixdiv(Cx a, int k) {
  return {sround(a.r * k), sround(a.i * k)};
}

__device__ __forceinline__ Cx cmul(Cx a, int2 b) {
  return {sround(a.r * b.x - a.i * b.y), sround(a.r * b.y + a.i * b.x)};
}

__device__ __forceinline__ Cx add(Cx a, Cx b) {
  return {wrap16(a.r + b.r), wrap16(a.i + b.i)};
}

__device__ __forceinline__ Cx sub(Cx a, Cx b) {
  return {wrap16(a.r - b.r), wrap16(a.i - b.i)};
}

// kf_bfly2, one butterfly
__device__ __forceinline__ void bfly2(Cx& x0, Cx& x1, int2 tw) {
  const Cx f0 = fixdiv(x0, 32767 / 2);
  const Cx t = cmul(fixdiv(x1, 32767 / 2), tw);
  x0 = add(f0, t);
  x1 = sub(f0, t);
}

// kf_bfly4, one butterfly, the inverse branch
__device__ __forceinline__ void bfly4(Cx& x0, Cx& x1, Cx& x2, Cx& x3,
                                      int2 tw1, int2 tw2, int2 tw3) {
  Cx f0 = fixdiv(x0, 32767 / 4);
  const Cx s0 = cmul(fixdiv(x1, 32767 / 4), tw1);
  const Cx s1 = cmul(fixdiv(x2, 32767 / 4), tw2);
  const Cx s2 = cmul(fixdiv(x3, 32767 / 4), tw3);
  const Cx s5 = sub(f0, s1);
  f0 = add(f0, s1);
  const Cx s3 = add(s0, s2);
  const Cx s4 = sub(s0, s2);
  x2 = sub(f0, s3);
  x0 = add(f0, s3);
  x1 = {wrap16(s5.r - s4.i), wrap16(s5.i + s4.r)};
  x3 = {wrap16(s5.r + s4.i), wrap16(s5.i - s4.r)};
}

template <int LOG2N>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
kiss_ifft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 const int32_t* __restrict__ gather,
                 const int2* __restrict__ twiddle,
                 int32_t* __restrict__ words, int32_t* __restrict__ yr,
                 int32_t* __restrict__ yi, long long n_symbols,
                 int n_carriers, int n_sym_tf, int null_size, int sym_size) {
  constexpr int N = 1 << LOG2N;
  constexpr int TS = N / kPoints;          // threads a symbol
  constexpr int SPB = kThreads / TS;       // symbols a block
  static_assert(SPB * 2 * N == kSmemInts);
  __shared__ __align__(16) int smem[kSmemInts];

  const int ls = threadIdx.x / TS;
  const int t = threadIdx.x % TS;
  const long long sym = static_cast<long long>(blockIdx.x) * SPB + ls;
  const bool live = sym < n_symbols;

  // 1. the symbol's carriers (C <= 3N/4) into its 2N words of shared memory
  float* cr = reinterpret_cast<float*>(smem) + ls * 2 * N;
  float* ci = cr + N;
  if (live) {
    const float4* gr = reinterpret_cast<const float4*>(xr + sym * n_carriers);
    const float4* gi = reinterpret_cast<const float4*>(xi + sym * n_carriers);
    for (int c = t; c < n_carriers / 4; c += TS) {
      reinterpret_cast<float4*>(cr)[c] = __ldg(&gr[c]);
      reinterpret_cast<float4*>(ci)[c] = __ldg(&gi[c]);
    }
  }
  __syncthreads();

  // 2. points 8t..8t+7 of KISS's input order, Q1.14 (round half to even)
  Cx v[kPoints];
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const int g = __ldg(&gather[kPoints * t + k]);
    const bool z = g >= n_carriers;
    const float re = z ? 0.0f : cr[g];
    const float im = z ? 0.0f : ci[g];
    v[k] = {__float2int_rn(re * 16384.0f), __float2int_rn(im * 16384.0f)};
  }
  __syncthreads();           // the carriers are read: the points take over

  // the deepest stages, whole butterflies in this thread's 8 points
  const int2 tw0 = __ldg(&twiddle[0]);
  if constexpr (LOG2N & 1) {
#pragma unroll
    for (int k = 0; k < kPoints; k += 2) bfly2(v[k], v[k + 1], tw0);
    bfly4(v[0], v[2], v[4], v[6], tw0, tw0, tw0);
    bfly4(v[1], v[3], v[5], v[7], __ldg(&twiddle[N / 8]),
          __ldg(&twiddle[2 * N / 8]), __ldg(&twiddle[3 * N / 8]));
  } else {
    bfly4(v[0], v[1], v[2], v[3], tw0, tw0, tw0);
    bfly4(v[4], v[5], v[6], v[7], tw0, tw0, tw0);
  }
  int* sr = smem + ls * 2 * N;
  int* si = sr + N;
  reinterpret_cast<int4*>(sr)[2 * t] =
      make_int4(v[0].r, v[1].r, v[2].r, v[3].r);
  reinterpret_cast<int4*>(sr)[2 * t + 1] =
      make_int4(v[4].r, v[5].r, v[6].r, v[7].r);
  reinterpret_cast<int4*>(si)[2 * t] =
      make_int4(v[0].i, v[1].i, v[2].i, v[3].i);
  reinterpret_cast<int4*>(si)[2 * t + 1] =
      make_int4(v[4].i, v[5].i, v[6].i, v[7].i);
  __syncthreads();

  // 3. the radix-4 stages (4, m), m = 8 or 4 up to N/4, in place
  constexpr int kFirstM = (LOG2N & 1) ? 8 : 4;
  constexpr int kStages = (LOG2N - (LOG2N & 1 ? 3 : 2)) / 2;
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    const int m = kFirstM << (2 * st);
    const int fstride = N / (4 * m);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = t + h * TS;            // butterfly (u / m, u % m)
      const int i = u % m;
      const int base = (u - i) * 4 + i;
      Cx a0 = {sr[base], si[base]};
      Cx a1 = {sr[base + m], si[base + m]};
      Cx a2 = {sr[base + 2 * m], si[base + 2 * m]};
      Cx a3 = {sr[base + 3 * m], si[base + 3 * m]};
      bfly4(a0, a1, a2, a3, __ldg(&twiddle[i * fstride]),
            __ldg(&twiddle[2 * i * fstride]),
            __ldg(&twiddle[3 * i * fstride]));
      sr[base] = a0.r;
      si[base] = a0.i;
      sr[base + m] = a1.r;
      si[base + m] = a1.i;
      sr[base + 2 * m] = a2.r;
      si[base + 2 * m] = a2.i;
      sr[base + 3 * m] = a3.r;
      si[base + 3 * m] = a3.i;
    }
    __syncthreads();
  }

  // 4. out
  if (!live) return;
  if (words != nullptr) {
    // 32-bit division (n_symbols < 2^31): a 64-bit one is a call that
    // spills
    const int b = static_cast<int>(sym) / n_sym_tf;
    const int s = static_cast<int>(sym) - b * n_sym_tf;
    const long long tf =
        null_size + static_cast<long long>(n_sym_tf - 1) * sym_size;
    const int pre = (s == 0 ? null_size : sym_size) - N;
    int32_t* q = words + b * tf + (s == 0 ? 0 : null_size + (s - 1) *
                                                    sym_size);
    for (int k = t; k < pre + N; k += TS) {
      const int n = k < pre ? N - pre + k : k - pre;
      q[k] = static_cast<int32_t>((static_cast<uint32_t>(si[n]) << 16) |
                                  (static_cast<uint32_t>(sr[n]) & 0xFFFFu));
    }
  } else {
    int4* qr = reinterpret_cast<int4*>(yr + sym * N);
    int4* qi = reinterpret_cast<int4*>(yi + sym * N);
    for (int k = t; k < N / 4; k += TS) {
      qr[k] = reinterpret_cast<const int4*>(sr)[k];
      qi[k] = reinterpret_cast<const int4*>(si)[k];
    }
  }
}

template <int LOG2N>
int launch(const void* xr, const void* xi, const void* gather,
           const void* twiddle, void* words, void* yr, void* yi,
           long long n_symbols, int n_carriers, int n_sym_tf, int null_size,
           int sym_size, cudaStream_t stream) {
  constexpr int spb = kThreads * kPoints / (1 << LOG2N);
  const long long blocks = (n_symbols + spb - 1) / spb;
  kiss_ifft_kernel<LOG2N><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const int32_t*>(gather), static_cast<const int2*>(twiddle),
      static_cast<int32_t*>(words), static_cast<int32_t*>(yr),
      static_cast<int32_t*>(yi), n_symbols, n_carriers, n_sym_tf, null_size,
      sym_size);
  return static_cast<int>(cudaGetLastError());
}

template <int LOG2N>
int shape(int* out) {
  out[0] = kThreads;
  out[1] = kThreads * kPoints / (1 << LOG2N);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], kiss_ifft_kernel<LOG2N>, kThreads, 0));
}

}  // namespace

// Launch on `stream` (a cudaStream_t).  The caller checks every argument:
// 1 <= n_symbols < 2^31 and a multiple of n_sym_tf, 4 <= n_carriers <= 3/4 of
// 2^log2n and a multiple of 4, 8 <= log2n <= 11, every gather entry in
// [0, n_carriers], the twiddles of kiss_kernel.make_table, the prefixes
// null_size - 2^log2n and sym_size - 2^log2n in [0, 2^log2n], all buffers
// on the current device.  `words` non-null: the wire words
// [n_symbols / n_sym_tf, null_size + (n_sym_tf - 1) * sym_size], yr and yi
// unused; else the planes yr, yi [n_symbols, 2^log2n].  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for another log2n.
extern "C" int dabmod_kiss_ifft(const void* xr, const void* xi,
                                const void* gather, const void* twiddle,
                                void* words, void* yr, void* yi,
                                long long n_symbols, int n_carriers,
                                int n_sym_tf, int null_size, int sym_size,
                                int log2n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log2n) {
    case 8: return launch<8>(xr, xi, gather, twiddle, words, yr, yi, n_symbols, n_carriers, n_sym_tf, null_size, sym_size, s);
    case 9: return launch<9>(xr, xi, gather, twiddle, words, yr, yi, n_symbols, n_carriers, n_sym_tf, null_size, sym_size, s);
    case 10: return launch<10>(xr, xi, gather, twiddle, words, yr, yi, n_symbols, n_carriers, n_sym_tf, null_size, sym_size, s);
    case 11: return launch<11>(xr, xi, gather, twiddle, words, yr, yi, n_symbols, n_carriers, n_sym_tf, null_size, sym_size, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch shape of the instance for 2^log2n on the current device:
// out[0] threads a block, out[1] symbols a block, out[2] resident blocks an
// SM by the CUDA runtime's occupancy calculator (no dynamic shared memory,
// as launched).  Returns the CUDA error code (0 = success), or
// cudaErrorInvalidValue for another log2n.
extern "C" int dabmod_kiss_ifft_shape(int log2n, int* out) {
  switch (log2n) {
    case 8: return shape<8>(out);
    case 9: return shape<9>(out);
    case 10: return shape<10>(out);
    case 11: return shape<11>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
