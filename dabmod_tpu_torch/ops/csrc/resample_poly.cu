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
// carried over.  No tensor cores: the fp32 floor already lies below the
// byte floor, and TF32 (10-bit mantissa) would break the rtol 1e-5 the
// kernel is held to against its plain version.
//
// What held the first version back was the rate at which an SM issues
// shared-memory loads: three 32-bit loads (input re, input im, tap) for
// every two multiply-adds, 99 a warp per 32 outputs.  This design:
//
// * A chunk is q_per_chunk output groups of L (q_per_chunk * L consecutive
//   outputs of each plane).  One wave of persistent blocks walks over the
//   chunks; a block stages the input run of its next chunk in shared
//   memory (cp.async, 4 bytes a thread, coalesced; the carry through its
//   own pointer, zeros past the stream, so the wrapper never
//   concatenates) while it computes and stores the current one.
// * A warp works on one output phase p at a time (a work item is a phase
//   and a run of tiles), so every lane needs the same taps[p]: each lane
//   holds them in registers, loaded again only when its phase changes.
//   K is padded at compile time to KP with zero taps and the band loop is
//   unrolled over compile-time tap indices; fmaf(x, 0, acc) == acc, so
//   the padding leaves each sum as it was.
// * Compile-time M (1 and 2, every rate of chip_smoke's RES_RATES): the
//   taps are aligned to row 0 (taps[p] moved down by row0[p], zeros before
//   it), so every phase reads the same window.  Each lane computes R
//   consecutive output groups, reads each input of its window,
//   (R-1)*M + KP samples, once, and feeds it to every accumulator that
//   needs it: 2*(R-1)*M + 2*KP shared loads for 2*R outputs, where the
//   first version issued 6*K.  The staged run is padded with one word
//   after every R*M (lanes start R*M + 1 words apart, an odd stride), so
//   every load of a warp hits 32 different banks.
// * Run-time M (any other plan the wrapper takes: 1.536, 1.792, 2.176
//   MS/s...): the taps stay in registers, each lane computes one output a
//   tile and reads its K inputs; the staged run is split into M rows by
//   input index mod M (xp[i*M + m] at row m, column i), so the 32 lanes
//   of a warp, on consecutive output groups, read consecutive words.
// * Each output still sums k = 0..K-1 in order with fmaf, wherever it
//   falls in a chunk, so two calls on the halves of a stream equal one
//   call bit for bit.  One output's band is never split across threads.
// * Outputs are staged in shared memory, one row per phase (column q XOR
//   (q / 32 mod 8): the writes of a warp hit 32 banks), and the block
//   writes a chunk's outputs as coalesced 16-byte streaming stores of
//   consecutive samples.  The row length is chosen by the wrapper so that
//   the reads behind those stores hit 32 banks where L is a power of two
//   (two wavefronts at odd L).
//
// Instances (M or 0 for run-time M, KP, R), in the order the wrapper
// indexes them (resampler_kernel.INSTANCES): see kInstances below.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Args {
  const float* xr;
  const float* xi;
  const float* cr;
  const float* ci;
  const int32_t* row0;
  const float* taps;      // [L, KP]: aligned to row 0 for compile-time M
  float* yr;
  float* yi;
  long long n_in;
  int h2, L, M, lg_m, K;
  int q_per_chunk;        // = 32 * R * tiles * groups
  int groups;             // work items a phase in a block
  int tiles;              // tiles of 32 * R output groups an item
  int span;               // input samples a block stages
  int in_row;             // run-time M: the staged run's row length
  int in_len;             // staged floats a plane
  int out_row;            // staged outputs a phase (>= q_per_chunk)
};

// Where input sample t of a block's run is staged.
template <int MT, int R>
__device__ __forceinline__ int staged(int t, const Args& a) {
  if constexpr (MT > 0) {
    constexpr int CH = R * MT;
    return t + t / CH;
  } else {
    return (t & (a.M - 1)) * a.in_row + (t >> a.lg_m);
  }
}

// Column of output group q in its phase's row of the staged output: q
// with its low three bits XORed with bits 5-7.  A warp's writes (32
// consecutive groups, or 32 lanes R groups apart for R = 4, 8) then hit 32
// banks, and so do the reads of 4 consecutive groups a lane at L = 1.
__device__ __forceinline__ int swz(int q) { return q ^ ((q >> 5) & 7); }

// The next output (p, q) -> (p + 1, q), or (0, q + 1) past phase L - 1.
__device__ __forceinline__ void step(int& p, int& q, int L) {
  if (++p == L) {
    p = 0;
    ++q;
  }
}

// Compile-time M: lane computes groups ql .. ql + R - 1 of phase row `out`.
template <int MT, int KP, int R>
__device__ __forceinline__ void tile_fixed(const float* s_xr,
                                           const float* s_xi,
                                           const float (&tp)[KP], int ql,
                                           float* out_r, float* out_i) {
  constexpr int CH = R * MT;
  constexpr int WIN = (R - 1) * MT + KP;
  // ql * MT is a multiple of CH: its staged index is (ql * MT / CH) * (CH + 1)
  const int base = (ql * MT / CH) * (CH + 1);
  const float* pr = s_xr + base;
  const float* pi = s_xi + base;
  float ar[R], ai[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ar[r] = 0.f;
    ai[r] = 0.f;
  }
#pragma unroll
  for (int w = 0; w < WIN; ++w) {
    const float vr = pr[w + w / CH];
    const float vi = pi[w + w / CH];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = w - r * MT;
      if (k >= 0 && k < KP) {
        ar[r] = fmaf(vr, tp[k], ar[r]);
        ai[r] = fmaf(vi, tp[k], ai[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    out_r[swz(ql + r)] = ar[r];
    out_i[swz(ql + r)] = ai[r];
  }
}

// Run-time M: lane computes group q of phase row `out`, whose band starts
// at run index q * M + r0.
template <int KP>
__device__ __forceinline__ void tile_any(const float* s_xr, const float* s_xi,
                                         const float (&tp)[KP], int q, int r0,
                                         const Args& a, float* out_r,
                                         float* out_i) {
  const int wrap_step = 1 - (a.M - 1) * a.in_row;
  int m = r0 & (a.M - 1);
  int off = m * a.in_row + (r0 >> a.lg_m) + q;
  float ar = 0.f, ai = 0.f;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    if (k >= a.K) break;
    ar = fmaf(s_xr[off], tp[k], ar);
    ai = fmaf(s_xi[off], tp[k], ai);
    const bool wrap = ++m == a.M;
    m = wrap ? 0 : m;
    off += wrap ? wrap_step : a.in_row;
  }
  out_r[swz(q)] = ar;
  out_i[swz(q)] = ai;
}

// Queue a 4-byte copy from global to shared memory (zero-filled when
// !valid; src must still be a valid address).
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Queue the copies of chunk c's input run into (s_xr, s_xi): xp[c*QB*M +
// t] for t < span, from the carry, from x, or zero past the stream.
template <int MT, int R>
__device__ __forceinline__ void stage(const Args& a, long long c, float* s_xr,
                                      float* s_xi) {
  const long long in0 = c * a.q_per_chunk * a.M;     // index into xp
  const long long n_xp = a.n_in + a.h2;
  if (in0 >= a.h2 && in0 + a.span <= n_xp) {          // all of it from x
    const float* xr = a.xr + (in0 - a.h2);
    const float* xi = a.xi + (in0 - a.h2);
    for (int t = threadIdx.x; t < a.span; t += kThreads) {
      const int s = staged<MT, R>(t, a);
      copy_async(s_xr + s, xr + t, true);
      copy_async(s_xi + s, xi + t, true);
    }
    return;
  }
  for (int t = threadIdx.x; t < a.span; t += kThreads) {
    const long long g = in0 + t;
    const float* pr = a.cr + g;
    const float* pi = a.ci + g;
    if (g >= a.h2) {
      const long long gx = g < n_xp ? g - a.h2 : 0;  // past the stream: 0s
      pr = a.xr + gx;
      pi = a.xi + gx;
    }
    const int s = staged<MT, R>(t, a);
    copy_async(s_xr + s, pr, g < n_xp);
    copy_async(s_xi + s, pi, g < n_xp);
  }
}

// Persistent: block b computes chunks b, b + gridDim.x, ... of q_per_chunk
// output groups; the next chunk's input run is copied into the other
// buffer while this one is computed and stored.  The register cap: at most
// 40 taps, 3 blocks an SM; 72, 2; else 1.
template <int MT, int KP, int R>
__global__ void __launch_bounds__(kThreads, KP <= 40 ? 3 : (KP <= 72 ? 2 : 1))
resample_poly(const Args a) {
  extern __shared__ float smem[];
  float* s_x = smem;                        // [2 buffers][re, im][in_len]
  float* s_yr = s_x + 4 * a.in_len;         // [L, out_row]
  float* s_yi = s_yr + a.L * a.out_row;     // [L, out_row]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long n_q = a.n_in / a.M;       // output groups of L
  const long long n_chunks = (n_q + a.q_per_chunk - 1) / a.q_per_chunk;
  long long c = blockIdx.x;
  if (c >= n_chunks) return;
  stage<MT, R>(a, c, s_x, s_x + a.in_len);
  float tp[KP];               // the taps of phase tap_p
  int tap_p = -1;
  for (int buf = 0; c < n_chunks; c += gridDim.x, buf ^= 1) {
    const float* s_xr = s_x + 2 * buf * a.in_len;
    const float* s_xi = s_xr + a.in_len;
    wait_copies();
    __syncthreads();          // the run is staged; the last chunk is stored
    if (c + gridDim.x < n_chunks) {
      float* next = s_x + 2 * (buf ^ 1) * a.in_len;
      stage<MT, R>(a, c + gridDim.x, next, next + a.in_len);
    }
    const long long q0 = c * a.q_per_chunk;
    const long long q_left = n_q - q0;
    const int nq_blk = static_cast<int>(
        q_left < a.q_per_chunk ? q_left : a.q_per_chunk);

    for (int item = tid >> 5; item < a.L * a.groups; item += kWarps) {
      const int p = item / a.groups;
      const int first = (item - p * a.groups) * a.tiles;
      if (p != tap_p) {       // with L * groups <= 8 warps, once a launch
#pragma unroll
        for (int k = 0; k < KP; ++k) tp[k] = __ldg(a.taps + p * KP + k);
        tap_p = p;
      }
      float* out_r = s_yr + p * a.out_row;
      float* out_i = s_yi + p * a.out_row;
      for (int tile = first; tile < first + a.tiles; ++tile) {
        const int tq = tile * 32 * R;
        if (tq >= nq_blk) break;            // past the stream's end
        if constexpr (MT > 0) {
          tile_fixed<MT, KP, R>(s_xr, s_xi, tp, tq + lane * R, out_r,
                                out_i);
        } else {
          tile_any<KP>(s_xr, s_xi, tp, tq + lane, __ldg(a.row0 + p), a,
                       out_r, out_i);
        }
      }
    }
    __syncthreads();

    // outputs o = q*L + p of the chunk, four consecutive a thread: one
    // 16-byte store a plane (y + q0*L is 16-byte aligned: the wrapper
    // checks y, and q_per_chunk is a multiple of 32)
    const int n_loc = nq_blk * a.L;
    float* gr = a.yr + q0 * a.L;
    float* gi = a.yi + q0 * a.L;
    constexpr int kStep = 4 * kThreads;
    const int dq = kStep / a.L;
    const int dp = kStep - dq * a.L;
    int o = 4 * tid;
    int q = o / a.L;
    int p = o - q * a.L;
    for (; o < n_loc; o += kStep) {
      int pe = p, qe = q;
      if (o + 4 <= n_loc) {
        float vr[4], vi[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int w = pe * a.out_row + swz(qe);
          vr[e] = s_yr[w];
          vi[e] = s_yi[w];
          step(pe, qe, a.L);
        }
        // streaming 16-byte stores (st.global.cs.v4): the output is not
        // read again here, and a plain float4 assignment compiled to four
        // 4-byte stores
        __stcs(reinterpret_cast<float4*>(gr + o),
               make_float4(vr[0], vr[1], vr[2], vr[3]));
        __stcs(reinterpret_cast<float4*>(gi + o),
               make_float4(vi[0], vi[1], vi[2], vi[3]));
      } else {                              // the stream's last outputs
        for (int e = o; e < n_loc; ++e) {
          const int w = pe * a.out_row + swz(qe);
          gr[e] = s_yr[w];
          gi[e] = s_yi[w];
          step(pe, qe, a.L);
        }
      }
      p += dp;
      q += dq;
      if (p >= a.L) {
        p -= a.L;
        ++q;
      }
    }
  }
}

struct Instance {
  int mt, kp, r;
};

// resampler_kernel.INSTANCES holds the same list in the same order.
constexpr Instance kInstances[] = {{1, 34, 8}, {2, 35, 8}, {2, 65, 4},
                                   {0, 40, 1}, {0, 72, 1}, {0, 132, 1}};
constexpr int kNumInstances = sizeof(kInstances) / sizeof(kInstances[0]);

using KernelFn = void (*)(const Args);

template <int I>
KernelFn kernel_of() {
  return resample_poly<kInstances[I].mt, kInstances[I].kp, kInstances[I].r>;
}

KernelFn kernel_at(int inst) {
  switch (inst) {
    case 0: return kernel_of<0>();
    case 1: return kernel_of<1>();
    case 2: return kernel_of<2>();
    case 3: return kernel_of<3>();
    case 4: return kernel_of<4>();
    case 5: return kernel_of<5>();
    default: return nullptr;
  }
}
static_assert(kNumInstances == 6, "kernel_at covers every instance");

// Lets `fn` launch with smem_bytes of dynamic shared memory (above 48 KB
// only after the attribute is raised).
cudaError_t allow_smem(KernelFn fn, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

// Resident blocks an SM of instance `inst` at smem_bytes, from the CUDA
// runtime's occupancy calculator, remembered for the last smem_bytes asked
// of each instance.
cudaError_t resident_blocks(int inst, KernelFn fn, int smem_bytes,
                            int* out) {
  static int smem_of[kNumInstances] = {-1, -1, -1, -1, -1, -1};
  static int blocks_of[kNumInstances];
  if (smem_of[inst] != smem_bytes) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_of[inst], fn, kThreads, static_cast<size_t>(smem_bytes));
    if (err != cudaSuccess) return err;
    if (blocks_of[inst] < 1) return cudaErrorInvalidConfiguration;
    smem_of[inst] = smem_bytes;
  }
  *out = blocks_of[inst];
  return cudaSuccess;
}

}  // namespace

// Launch instance `inst` on `stream` (a cudaStream_t).  The caller
// (resampler_kernel.resample) checks every argument: n_in > 0 a multiple
// of M, M a power of two with lg_m = log2 M, the instance's M and KP
// matching the table (taps [L, KP]), q_per_chunk = 32 * R * tiles *
// groups, span / in_row / in_len / out_row / smem_bytes as make_table
// computes them, y 16-byte aligned, all buffers on the current device.
// Returns a CUDA error code (0 = launched).
extern "C" int dabmod_resample_poly(const void* xr, const void* xi,
                                    const void* carry_r, const void* carry_i,
                                    const void* row0, const void* taps,
                                    void* yr, void* yi, long long n_in,
                                    int inst, int h2, int L, int M, int lg_m,
                                    int K, int q_per_chunk, int groups,
                                    int tiles, int span, int in_row,
                                    int in_len, int out_row, int smem_bytes,
                                    void* stream) {
  const KernelFn fn = kernel_at(inst);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(fn, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.xr = static_cast<const float*>(xr);
  a.xi = static_cast<const float*>(xi);
  a.cr = static_cast<const float*>(carry_r);
  a.ci = static_cast<const float*>(carry_i);
  a.row0 = static_cast<const int32_t*>(row0);
  a.taps = static_cast<const float*>(taps);
  a.yr = static_cast<float*>(yr);
  a.yi = static_cast<float*>(yi);
  a.n_in = n_in;
  a.h2 = h2;
  a.L = L;
  a.M = M;
  a.lg_m = lg_m;
  a.K = K;
  a.q_per_chunk = q_per_chunk;
  a.groups = groups;
  a.tiles = tiles;
  a.span = span;
  a.in_row = in_row;
  a.in_len = in_len;
  a.out_row = out_row;
  // one wave of persistent blocks: as many as the card holds at once
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = resident_blocks(inst, fn, smem_bytes, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_q = n_in / M;
  const long long chunks = (n_q + q_per_chunk - 1) / q_per_chunk;
  const long long wave = static_cast<long long>(sms) * per_sm;
  const long long blocks = chunks < wave ? chunks : wave;
  fn<<<static_cast<unsigned>(blocks), kThreads,
       static_cast<size_t>(smem_bytes), static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

// Instance `inst` as this source builds it and its launch shape on the
// current device at smem_bytes of dynamic shared memory: out[0] threads a
// block, out[1] its compile-time M (0: any), out[2] KP, out[3] R, out[4]
// resident blocks an SM by the CUDA runtime's occupancy calculator.
// Returns a CUDA error code (0 = success).
extern "C" int dabmod_resample_poly_shape(int inst, int smem_bytes,
                                          int* out) {
  const KernelFn fn = kernel_at(inst);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(fn, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kThreads;
  out[1] = kInstances[inst].mt;
  out[2] = kInstances[inst].kp;
  out[3] = kInstances[inst].r;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[4], fn, kThreads, static_cast<size_t>(smem_bytes)));
}
