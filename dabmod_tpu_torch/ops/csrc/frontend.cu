// The front end (K5) for Hopper (sm_90a): ETI payload bytes to the OFDM
// backend's carrier planes, in one launch.
//
// It replaces no TPU kernel: the TPU package runs this chain as XLA ops
// (dabmod_tpu/ops/fec.py, ops/ofdm.py), which XLA fuses.  On the card the
// port ran it as eager torch ops, some 410 launches a captured step
// whatever the batch (ops/frontend_kernel.py::frontend_plain): for the FIC
// and each sub-channel unpack_bits, the scramble XOR, four generators of
// XORs over strided slices, cat, stack, index_select and pad; the time
// interleaver's cat, stack and clone; the CIF overlay, block partition,
// QPSK mapping, the differential cumsum, the carrier values and the NULL
// row.  This kernel computes, bit for bit as that chain:
//
//   * every punctured, time-interleaved bit of the batch's TFs, gathered
//     from the input bytes through tables built once from the layout
//     (ops/frontend_kernel.py::make_table): for CIF bit x its owner unit
//     and punctured bit p (cif_src, the last writer's, as assemble_cif
//     overlays) or the PRBS filler; the source CIF t - TI_DELAYS[p mod 16],
//     this batch's or the old history's; the mother-code index m =
//     keep[p] (-1 in the padding, a zero bit); and generator (m mod 4)'s
//     taps over the scrambled input bits s, .., s - 6 of encoder step
//     s = m div 4, zeros outside the frame, as a 7-bit window and a parity;
//   * per (TF, carrier) the phase walk from the phase reference,
//     q = [1,7,3,5][2 bI + bQ] for each data symbol, and the carrier
//     values of phases_to_carriers (+-1, +-0, +-float32(sqrt(1/2)), in the
//     same float32 products), the NULL row (TII on TFs whose index is even)
//     and the CIC taps, one float32 product;
//   * the new time-interleaver history: the last 15 CIFs of punctured
//     bits, from this batch or, below 15 CIFs a batch, shifted from the
//     old history.
//
// What bounds it on the H100: device memory, and far below where it runs.
// A 24-TF TM I step reads 96 frames of 3,528 payload bytes (0.34 MB), at
// most 0.8 MB of history and 0.4 MB of tables, and writes
// [24, 77, 1536] x 2 float32 planes (22.7 MB): 7 us at 3.35 TB/s.  The
// integer work is about 40 instructions a bit over 5.5 M bits.  What cost
// was the number of launches and of trips through memory; the design:
//   1. One launch of two kinds of block.  A symbol block takes one TF and
//      32 carriers, 8 warps: lane = carrier, so neighbouring threads read
//      neighbouring bits (cif_src, keep) and write neighbouring floats.
//      Each warp computes the QPSK index q of every 8th data symbol from
//      its two bits into shared memory (160 x 32 bytes); after one barrier
//      each warp walks one stretch of the TF's rows, the phase sum of the
//      symbols before it first, and writes its rows, 128 bytes a row and
//      plane a warp.  A history block writes 256 history bytes, one a
//      thread.
//   2. The sub-channels' bytes and histories come as separate tensors (the
//      captured step's static inputs): their pointers, with each unit's
//      sizes and table offsets, travel in the kernel's parameters as a
//      __grid_constant__ struct (Units), read in place.  Nothing is copied
//      to the card for them, no torch.cat stages them, and a CUDA graph
//      holds the parameters with the static buffers' addresses.
//   3. The tables (cif_src, keep, packed PRBS, filler; about 0.4 MB at
//      TM I) stay in L2; every read of them and of the bytes is __ldg.
//   4. No allocation, no host synchronisation: the wrapper allocates the
//      planes and one flat history buffer, so the launch is captured in
//      the step's graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // a block
constexpr int kLanes = 32;                 // carriers a symbol block
constexpr int kWarps = kThreads / kLanes;  // 8
constexpr int kMaxSymbols = 160;           // data symbols a TF (TM III: 152)
constexpr int kMaxUnits = 65;              // the FIC and 64 sub-channels
constexpr int kHistory = 15;               // CIFs of interleaver history
constexpr int kCifBits = 864 * 64;
// the generators' taps (tables.CONV_TAPS: 133, 171, 145, 133 octal) as
// 7-bit masks over input bits s, s-1, .., s-6, one a byte
constexpr unsigned kGenMasks = 0x6Du | 0x4Fu << 8 | 0x53u << 16 | 0x6Du << 24;
// [1,7,3,5][2 bI + bQ], one a nibble
constexpr unsigned kQpsk = 0x5371u;
constexpr float kHalf = 0.7071067811865476f;   // float32(sqrt(1/2))

// Unit 0 is the FIC, unit i + 1 sub-channel i (ops/frontend_kernel.py
// _Units has the same layout)
struct Units {
  const uint8_t* bytes[kMaxUnits];      // [frames, n_bytes] this batch
  const uint8_t* hist_in[kMaxUnits];    // [15, width] (sub-channels)
  int n_bytes[kMaxUnits];               // input bytes a frame
  int prbs[kMaxUnits];                  // offset of its packed PRBS
  int keep[kMaxUnits];                  // offset of its mother-code indices
  int width[kMaxUnits];                 // punctured bits a frame
  int hist_out[kMaxUnits];              // offset of its new history
  int n_units;
};

struct Tables {
  const uint8_t* prbs;      // each unit's PRBS, packed MSB first
  const int* keep;          // mother-code indices, -1 the padding
  const int* cif_src;       // [CIF bits]: unit << 16 | p, -1 the filler
  const uint8_t* filler;    // [CIF bits]: the PRBS filler's bits
};

// TI_DELAYS[p mod 16]: 0..15 bit-reversed
__device__ __forceinline__ int ti_delay(int p) {
  return static_cast<int>(__brev(static_cast<unsigned>(p & 15)) >> 28);
}

// encoder output m (mother-code index) of unit k's frame f
__device__ __forceinline__ int conv_bit(const Units& u, const Tables& t,
                                        int k, int f, int m) {
  const int lo = (m >> 2) - 6;           // step s's oldest tap, s - 6
  const int j0 = lo >> 3;                // its byte (floor: lo >= -6)
  const int n = u.n_bytes[k];
  const uint8_t* row = u.bytes[k] + static_cast<long long>(f) * n;
  const uint8_t* pr = t.prbs + u.prbs[k];
  const unsigned b0 = j0 >= 0 ? __ldg(&row[j0]) ^ __ldg(&pr[j0]) : 0u;
  const unsigned b1 = j0 + 1 < n ? __ldg(&row[j0 + 1]) ^ __ldg(&pr[j0 + 1])
                                 : 0u;
  // bit i of the window is input bit s - i
  const unsigned w = ((b0 << 8 | b1) >> (9 - (lo & 7))) & 0x7Fu;
  return __popc(w & (kGenMasks >> (8 * (m & 3)))) & 1;
}

// punctured bit p of unit k's frame f
__device__ __forceinline__ int punct_bit(const Units& u, const Tables& t,
                                         int k, int f, int p) {
  const int m = __ldg(&t.keep[u.keep[k] + p]);
  return m < 0 ? 0 : conv_bit(u, t, k, f, m);
}

// bit j of TF b's stream ([cif_count x FIC][cif_count x CIF])
__device__ __forceinline__ int tf_bit(const Units& u, const Tables& t,
                                      int cif_count, int fic_width, int b,
                                      int j) {
  const int fic_bits = cif_count * fic_width;
  if (j < fic_bits) {
    const int c = j / fic_width;
    return punct_bit(u, t, 0, b * cif_count + c, j - c * fic_width);
  }
  j -= fic_bits;
  const int c = j / kCifBits;
  const int x = j - c * kCifBits;
  const int src = __ldg(&t.cif_src[x]);
  if (src < 0) return __ldg(&t.filler[x]);
  const int k = src >> 16;
  const int p = src & 0xFFFF;
  const int f = b * cif_count + c - ti_delay(p);   // the source CIF
  if (f >= 0) return punct_bit(u, t, k, f, p);
  return __ldg(&u.hist_in[k][(kHistory + f) * u.width[k] + p]);
}

// phases_to_carriers of the eighth-turn index q
__device__ __forceinline__ void carrier(int q, float& re, float& im) {
  const int b1 = (q >> 1) & 1;
  const int b2 = (q >> 2) & 1;
  const float sb2 = static_cast<float>(1 - 2 * b2);
  if (q & 1) {
    re = __fmul_rn(kHalf, static_cast<float>(1 - 2 * (b1 ^ b2)));
    im = __fmul_rn(kHalf, sb2);
  } else {
    re = __fmul_rn(static_cast<float>(1 - b1), sb2);
    im = __fmul_rn(static_cast<float>(b1), sb2);
  }
}

__global__ void __launch_bounds__(kThreads)
frontend_kernel(const __grid_constant__ Units u, const Tables t,
                const int* __restrict__ ref_q,
                const float* __restrict__ tii_re,
                const float* __restrict__ tii_im,
                const float* __restrict__ cic,
                const int* __restrict__ tf_index,
                float* __restrict__ out_re, float* __restrict__ out_im,
                uint8_t* __restrict__ hist, int frames, int cif_count,
                int n_sym, int n_carriers, int fic_width, int sym_blocks,
                int hist_elems) {
  if (static_cast<int>(blockIdx.x) >= sym_blocks) {
    // a history block: new history byte e = (unit k, row r, bit p), the
    // punctured bit of CIF frames + r - 15 (this batch's or the old
    // history's row frames + r)
    const int e = (static_cast<int>(blockIdx.x) - sym_blocks) * kThreads +
                  static_cast<int>(threadIdx.x);
    if (e >= hist_elems) return;
    int k = 1;
    while (k + 1 < u.n_units && u.hist_out[k + 1] <= e) ++k;
    const int w = u.width[k];
    const int r = (e - u.hist_out[k]) / w;
    const int p = e - u.hist_out[k] - r * w;
    const int f = frames + r - kHistory;
    hist[e] = static_cast<uint8_t>(
        f >= 0 ? punct_bit(u, t, k, f, p)
               : __ldg(&u.hist_in[k][(frames + r) * w + p]));
    return;
  }

  // a symbol block: TF b, carriers c0 .. c0 + 31
  __shared__ uint8_t qs[kMaxSymbols][kLanes];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int chunks = (n_carriers + kLanes - 1) / kLanes;
  const int b = blockIdx.x / chunks;
  const int c = (blockIdx.x - b * chunks) * kLanes + lane;
  const bool live = c < n_carriers;
  if (live) {
    for (int l = warp; l < n_sym; l += kWarps) {
      const int j = 2 * l * n_carriers + c;    // the I bit; Q is C later
      const int bi = tf_bit(u, t, cif_count, fic_width, b, j);
      const int bq = tf_bit(u, t, cif_count, fic_width, b, j + n_carriers);
      qs[l][lane] = static_cast<uint8_t>((kQpsk >> (4 * (2 * bi + bq))) & 7);
    }
  }
  __syncthreads();
  if (!live) return;

  // rows s0 .. s1 - 1 of the TF's S = L + 2: NULL, the phase reference,
  // the data symbols; row s >= 1 takes ref_q + q[0] + .. + q[s - 2]
  const int rows = n_sym + 2;
  const int per = (rows + kWarps - 1) / kWarps;
  const int s0 = warp * per;
  const int s1 = min(rows, s0 + per);
  int acc = __ldg(&ref_q[c]);
  for (int l = 0; l < s0 - 2; ++l) acc += qs[l][lane];
  const float tap = cic != nullptr ? __ldg(&cic[c]) : 1.0f;
  const long long base = static_cast<long long>(b) * rows * n_carriers + c;
  for (int s = s0; s < s1; ++s) {
    float re, im;
    if (s == 0) {
      if (tii_re != nullptr) {
        // TII in the NULL symbol of the TFs with an even index
        const float insert = ((__ldg(tf_index) + b) & 1) ? 0.0f : 1.0f;
        re = __fmul_rn(__ldg(&tii_re[c]), insert);
        im = __fmul_rn(__ldg(&tii_im[c]), insert);
      } else {
        re = im = 0.0f;
      }
    } else {
      if (s >= 2) acc += qs[s - 2][lane];
      carrier(acc & 7, re, im);
    }
    if (cic != nullptr) {
      re = __fmul_rn(re, tap);
      im = __fmul_rn(im, tap);
    }
    out_re[base + static_cast<long long>(s) * n_carriers] = re;
    out_im[base + static_cast<long long>(s) * n_carriers] = im;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t).  The caller checks every argument:
// `units` points to a host Units with n_units units (1 .. 65), each
// unit's bytes [frames, n_bytes] and, for a sub-channel, its history
// [15, width] on the current device, the tables of
// ops/frontend_kernel.py::make_table (prbs, keep, cif_src, filler, ref_q
// [n_carriers]), tii_re and tii_im [n_carriers] or both null, cic
// [n_carriers] or null, tf_index one int32, out_re and out_im
// [frames / cif_count, n_sym + 2, n_carriers], hist the sub-channels'
// new histories one after another at units->hist_out; frames >= 1 a
// multiple of cif_count, n_sym <= 160.  Returns cudaGetLastError() after
// the launch (0 = launched), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int dabmod_frontend(const void* units, const void* prbs,
                               const void* keep, const void* cif_src,
                               const void* filler, const void* ref_q,
                               const void* tii_re, const void* tii_im,
                               const void* cic, const void* tf_index,
                               void* out_re, void* out_im, void* hist,
                               int frames, int cif_count, int n_sym,
                               int n_carriers, int fic_width, void* stream) {
  const Units& u = *static_cast<const Units*>(units);
  if (u.n_units < 1 || u.n_units > kMaxUnits || n_sym < 1 ||
      n_sym > kMaxSymbols || n_carriers < 1 || cif_count < 1 ||
      frames < cif_count || frames % cif_count != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int hist_elems = 0;
  for (int k = 1; k < u.n_units; ++k) hist_elems += kHistory * u.width[k];
  const int chunks = (n_carriers + kLanes - 1) / kLanes;
  const int sym_blocks = frames / cif_count * chunks;
  const int blocks = sym_blocks + (hist_elems + kThreads - 1) / kThreads;
  const Tables t{static_cast<const uint8_t*>(prbs),
                 static_cast<const int*>(keep),
                 static_cast<const int*>(cif_src),
                 static_cast<const uint8_t*>(filler)};
  frontend_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, t, static_cast<const int*>(ref_q),
      static_cast<const float*>(tii_re), static_cast<const float*>(tii_im),
      static_cast<const float*>(cic), static_cast<const int*>(tf_index),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<uint8_t*>(hist), frames, cif_count, n_sym, n_carriers,
      fic_width, sym_blocks, hist_elems);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape on the current device: out[0] threads a block, out[1]
// carriers a symbol block, out[2] resident blocks an SM by the CUDA
// runtime's occupancy calculator (no dynamic shared memory, as launched).
// Returns the CUDA error code (0 = success).
extern "C" int dabmod_frontend_shape(int* out) {
  out[0] = kThreads;
  out[1] = kLanes;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], frontend_kernel, kThreads, 0));
}
