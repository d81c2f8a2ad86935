"""PrecisionWave DEXTER FFT-accelerator offload (``fft_engine=dexter``):
the port's copy of dabmod_tpu/io/dexter_fft.py (NumPy only, unchanged).

The DEXTER platform carries an FFT accelerator in its FPGA, fed over two
libiio streaming devices; the reference host only performs carrier->bin
placement, pushes 16-bit I/Q bins, and collects 32-bit I/Q time-domain
samples which the fixed-point windowed guard-interval inserter and a
``complexfix_wide`` FormatConverter turn into the s16 wire
(ref: src/OfdmGenerator.cpp:581-789, src/DabModulator.cpp:214-221,271-277,
src/FormatConverter.cpp:70-109).

The card's job ends at Q1.14 carrier symbols; this chain runs on the host
(the runtime's fetch thread), for deployments that drive the actual DEXTER
FPGA, where the transform leaves the host by design.  The libiio surface
is injectable, and a software model of the accelerator backs the tests.
The accelerator itself is a hardware black box; the model declares its
arithmetic (see :class:`MockFftAcceleratorIio`) instead of guessing the
FPGA's internal bit behaviour.

Everything *around* the black box is exact to the reference: the pos/neg/
zero placement arithmetic, the one-buffer-in-flight pipelining, the buffer
size validation, the Q16.16 (fpm ``fixed_16_16``) windowed guard interval,
and the wide->s16 ``>> 6`` saturating conversion.
"""
from __future__ import annotations

import dataclasses
import logging
import threading

import numpy as np

log = logging.getLogger("dabmod_tpu_torch.dexter_fft")

_Q16_ONE = 1 << 16


# ---------------------------------------------------------------------------
# carrier -> FFT-bin placement (ref: src/OfdmGenerator.cpp:594-601; for TM I:
# ZeroDst=769 ZeroSize=511 / PosSrc=0 PosDst=1 PosSize=768 / NegSrc=768
# NegDst=1280 NegSize=768)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BinPlacement:
    pos_src: int
    pos_dst: int
    pos_size: int
    neg_src: int
    neg_dst: int
    neg_size: int
    zero_dst: int
    zero_size: int


def bin_placement(nb_carriers: int, spacing: int) -> BinPlacement:
    if nb_carriers > spacing:
        raise ValueError("OfdmGenerator nbCarriers > spacing!")
    pos_dst = 0 if (nb_carriers & 1) else 1
    pos_size = (nb_carriers + 1) // 2
    neg_dst = spacing - nb_carriers // 2
    zero_dst = pos_dst + pos_size
    return BinPlacement(
        pos_src=0, pos_dst=pos_dst, pos_size=pos_size,
        neg_src=pos_size, neg_dst=neg_dst, neg_size=nb_carriers // 2,
        zero_dst=zero_dst, zero_size=neg_dst - zero_dst)


# ---------------------------------------------------------------------------
# software model of the accelerator, exposed through the same pylibiio-style
# facade the Dexter output driver uses (Context / find_device / Buffer)
# ---------------------------------------------------------------------------
class _MockChannel:
    def __init__(self):
        self.enabled = False


class _MockDevice:
    def __init__(self, name, owner):
        self.name = name
        self._owner = owner
        self._channels = {}

    def find_channel(self, name, is_output):
        return self._channels.setdefault((name, bool(is_output)),
                                         _MockChannel())


class _MockInBuffer:
    """Input-side streaming buffer: ``write(bytes)`` + ``push()``."""

    def __init__(self, owner, device, nbytes):
        self._owner = owner
        self.nbytes = nbytes
        self._pending = b""

    def write(self, data: bytes):
        self._pending = bytes(data)

    def push(self):
        if len(self._pending) != self.nbytes:
            raise OSError("iio push: wrong buffer fill")
        self._owner._push_input(self._pending)


class _MockOutBuffer:
    """Output-side streaming buffer: ``refill()`` + ``read()``."""

    def __init__(self, owner, device, nbytes):
        self._owner = owner
        self.nbytes = nbytes
        self._current = None

    def refill(self):
        self._current = self._owner._pop_output()
        if len(self._current) != self.nbytes:
            raise OSError("iio refill: wrong buffer size")
        return len(self._current)

    def read(self) -> bytes:
        if self._current is None:
            raise OSError("iio read before refill")
        return self._current


class MockFftAcceleratorIio:
    """Software stand-in for the DEXTER FFT accelerator's libiio surface.

    Declared arithmetic of the modeled accelerator: an inverse DFT of the
    Q1.14 input bins with block scaling ``64 / N`` applied, rounded half
    away from zero to the 32-bit output word.  After the reference's
    ``>> 6`` wide->s16 conversion (src/FormatConverter.cpp:77,92) this
    lands the time-domain samples on the same Q1.14 amplitude scale as the
    reference's KISS fixed chain (which applies 1/N scaling across its
    butterfly stages, kiss/kiss_fft.c C_FIXDIV), so the two fixed-point
    engines produce directly comparable s16 output -- the property the
    tests pin down.  The real FPGA's internal scaling is hardware-defined;
    deployments calibrate via the device gain exactly as with the
    reference.

    IIO keeps several buffers in flight (the reference relies on this for
    its one-buffer-lag pipelining, src/OfdmGenerator.cpp:715-718); the
    model allows up to 4 pushed-but-uncollected transforms.
    """

    MAX_IN_FLIGHT = 4

    def __init__(self, spacing: int):
        self.spacing = spacing
        self._lock = threading.Lock()
        self._results: list[bytes] = []
        self.n_transforms = 0
        self._dev_in = _MockDevice("fft-accelerator-in", self)
        self._dev_out = _MockDevice("fft-accelerator-out", self)
        # precompute the inverse-DFT twiddle matrix once (float64 keeps
        # the int16-input x int-rounded-output model exactly reproducible)
        k = np.arange(spacing)
        self._w = np.exp(2j * np.pi * np.outer(k, k) / spacing)

    # -- facade ------------------------------------------------------------
    def Context(self):
        return self

    def find_device(self, name):
        return {"fft-accelerator-in": self._dev_in,
                "fft-accelerator-out": self._dev_out}.get(name)

    def Buffer(self, device, samples_count):
        # pylibiio convention: the second argument is a SAMPLE count; the
        # byte size follows from the device's enabled channel format
        # (16+16-bit in, 32+32-bit out) -- same convention as the Dexter
        # output driver's Buffer(dev, IIO_BUFFER_LEN_SAMPS)
        if device is self._dev_in:
            return _MockInBuffer(self, device, samples_count * 4)
        if device is self._dev_out:
            return _MockOutBuffer(self, device, samples_count * 8)
        raise OSError("iio buffer on unknown device")

    # -- modeled accelerator ----------------------------------------------
    def _push_input(self, payload: bytes):
        with self._lock:
            if len(self._results) >= self.MAX_IN_FLIGHT:
                raise OSError("iio push: FIFO full")
            bins = np.frombuffer(payload, np.int16).astype(np.float64)
            c = bins[0::2] + 1j * bins[1::2]
            td = self._w @ c * (64.0 / self.spacing)
            out = np.empty(2 * self.spacing, np.int64)
            out[0::2] = np.floor(np.abs(td.real) + 0.5) * np.sign(td.real)
            out[1::2] = np.floor(np.abs(td.imag) + 0.5) * np.sign(td.imag)
            self._results.append(out.astype(np.int32).tobytes())
            self.n_transforms += 1

    def _pop_output(self) -> bytes:
        with self._lock:
            if not self._results:
                raise OSError("iio refill: no transform pending")
            return self._results.pop(0)


# ---------------------------------------------------------------------------
# host-side generator: bin placement + IIO pipelining
# (ref: src/OfdmGenerator.cpp:675-789)
# ---------------------------------------------------------------------------
class DexterFftAccelerator:
    """Streams symbols through the FFT accelerator, one buffer in flight."""

    def __init__(self, nb_symbols: int, nb_carriers: int, spacing: int,
                 iio_module=None):
        log.info("Using DEXTER FFT Accelerator for fixed-point transform")
        self.nb_symbols = nb_symbols
        self.nb_carriers = nb_carriers
        self.spacing = spacing
        self.place = bin_placement(nb_carriers, spacing)
        if iio_module is None:
            import iio as iio_module  # noqa: PLC0415
        self._ctx = iio_module.Context()
        self._dev_in = self._find("fft-accelerator-in")
        self._dev_out = self._find("fft-accelerator-out")
        self._ch_in = self._dev_in.find_channel("voltage0", True)
        self._ch_out = self._dev_out.find_channel("voltage0", False)
        if self._ch_in is None or self._ch_out is None:
            raise RuntimeError("Failed to set FFT for OfdmGeneratorDEXTER")
        self._ch_in.enabled = True
        self._ch_out.enabled = True
        # 16-bit I + 16-bit Q in, 32-bit I + 32-bit Q out
        # (ref: src/OfdmGenerator.cpp:621-622,772-773)
        self._nbytes_in = spacing * 4
        self._nbytes_out = spacing * 8
        # pylibiio Buffer takes a sample count (one transform per buffer);
        # byte sizes above are what push/refill must carry
        self._buf_in = iio_module.Buffer(self._dev_in, spacing)
        self._buf_out = iio_module.Buffer(self._dev_out, spacing)

    def _find(self, name):
        dev = self._ctx.find_device(name)
        if dev is None:
            raise RuntimeError("Failed to set FFT for OfdmGeneratorDEXTER")
        return dev

    def process(self, sym_re: np.ndarray, sym_im: np.ndarray):
        """[S, nb_carriers] int16-valued arrays -> [S, spacing] int32 wide
        planes.  Pushes symbol i while symbol i-1's transform is collected
        (ref: src/OfdmGenerator.cpp:706-765)."""
        S = sym_re.shape[0]
        if sym_re.shape != (S, self.nb_carriers):
            raise ValueError("OfdmGenerator::process input size not valid!")
        p = self.place
        out_re = np.empty((S, self.spacing), np.int32)
        out_im = np.empty((S, self.spacing), np.int32)
        fft_in = np.zeros(2 * self.spacing, np.int16)

        def collect(i):
            self._buf_out.refill()
            wide = np.frombuffer(self._buf_out.read(), np.int32)
            out_re[i] = wide[0::2]
            out_im[i] = wide[1::2]

        for i in range(S):
            fft_in[:] = 0
            lo, hi = 2 * p.pos_dst, 2 * (p.pos_dst + p.pos_size)
            fft_in[lo:hi:2] = sym_re[i, p.pos_src:p.pos_src + p.pos_size]
            fft_in[lo + 1:hi:2] = sym_im[i, p.pos_src:p.pos_src + p.pos_size]
            lo, hi = 2 * p.neg_dst, 2 * (p.neg_dst + p.neg_size)
            fft_in[lo:hi:2] = sym_re[i, p.neg_src:p.neg_src + p.neg_size]
            fft_in[lo + 1:hi:2] = sym_im[i, p.neg_src:p.neg_src + p.neg_size]
            self._buf_in.write(fft_in.tobytes())
            self._buf_in.push()
            if i > 0:
                collect(i - 1)
        collect(S - 1)
        return out_re, out_im


# ---------------------------------------------------------------------------
# fpm Q16.16 (fixed_16_16) arithmetic for the wide windowed guard interval
# (src/GuardIntervalInserter.cpp:105-111 windowFixWide, do_process<
#  complexfix_wide>; fpm/fixed.hpp:156-167 EnableRounding multiply)
# ---------------------------------------------------------------------------
def window_q16(values: np.ndarray) -> np.ndarray:
    """fpm fixed(double) construction: round half away from zero."""
    return np.floor(values * _Q16_ONE + 0.5).astype(np.int64)


def _wrap32(x):
    return ((x.astype(np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def fpm_mul_q16(x, w):
    """fixed_16_16 * fixed_16_16 with EnableRounding: v = (x*w)/2^15 with C
    truncating division, result v/2 + v%2.  ``w`` (window) >= 0."""
    prod = x.astype(np.int64) * w
    sign = np.where(prod < 0, -1, 1)
    v_abs = np.abs(prod) >> 15
    return _wrap32(sign * ((v_abs >> 1) + (v_abs & 1)))


def guard_interval_windowed_wide(symbols, null_size: int, sym_size: int,
                                 ov: int):
    """Raised-cosine windowed GI on int32 wide planes [B, S, spacing] ->
    [B, tf_samples], mirroring ops.kiss_fixed.guard_interval_windowed_fixed
    but in Q16.16 (the DEXTER chain's complexfix_wide sample type)."""
    B, S, sp = symbols[0].shape
    npre = null_size - sp
    win = 0.5 * (1.0 - np.cos(np.pi * np.arange(2 * ov) / (2 * ov - 1)))
    wq = window_q16(win)
    rise1, rise2 = wq[:ov], wq[ov:2 * ov]
    fall1, fall2 = wq[2 * ov - 1:ov - 1:-1], wq[ov - 1::-1]

    def one(x):
        x = x.astype(np.int64)
        data = x[:, 1:]
        head = _wrap32(
            fpm_mul_q16(data[:, :, 2 * sp - sym_size:2 * sp - sym_size + ov],
                        rise2)
            + fpm_mul_q16(x[:, :-1, :ov], fall2))
        mid_prefix = data[:, :, 2 * sp - sym_size + ov:sp]
        body = data[:, :, :sp - ov]
        tails = np.concatenate(
            [_wrap32(fpm_mul_q16(data[:, :-1, sp - ov:], fall1)
                     + fpm_mul_q16(
                         data[:, 1:, 2 * sp - sym_size - ov:
                              2 * sp - sym_size], rise1)),
             data[:, -1:, sp - ov:]], axis=1)
        blocks = np.concatenate([head, mid_prefix, body, tails], axis=2)
        null = x[:, 0]
        null_tail = _wrap32(
            fpm_mul_q16(null[:, sp - ov:], fall1)
            + fpm_mul_q16(data[:, 0, 2 * sp - sym_size - ov:
                               2 * sp - sym_size], rise1))
        null_block = np.concatenate(
            [null[:, sp - npre:], null[:, :sp - ov], null_tail], axis=1)
        return np.concatenate(
            [null_block, blocks.reshape(B, -1)], axis=1).astype(np.int32)
    return one(symbols[0]), one(symbols[1])


def guard_interval_unwindowed_wide(symbols, null_size: int, sym_size: int):
    """Plain cyclic-prefix GI (windowOverlap == 0) on wide planes."""
    B, S, sp = symbols[0].shape

    def one(x):
        null = np.concatenate([x[:, 0, sp - (null_size - sp):], x[:, 0]],
                              axis=1)
        data = np.concatenate(
            [x[:, 1:, 2 * sp - sym_size:], x[:, 1:]], axis=2)
        return np.concatenate([null, data.reshape(B, -1)], axis=1)
    return one(symbols[0]), one(symbols[1])


def format_convert_wide_s16(re_i32, im_i32):
    """complexfix_wide -> s16: ``>> 6`` then saturate, counting clipped
    components (ref: src/FormatConverter.cpp:70-109)."""
    vals = np.empty((*re_i32.shape, 2), np.int32)
    vals[..., 0] = re_i32
    vals[..., 1] = im_i32
    shifted = vals >> 6
    n_clipped = int(np.count_nonzero(shifted < -32768)
                    + np.count_nonzero(shifted > 32767))
    return np.clip(shifted, -32768, 32767).astype(np.int16), n_clipped


# ---------------------------------------------------------------------------
# full host back end: what runs after the device hands over Q1.14 symbols
# ---------------------------------------------------------------------------
class DexterOfdmChain:
    """Accelerator + wide GI + wide->s16 FormatConverter for one layout.

    Mirrors the reference's post-TII chain for fftEngine == DEXTER
    (src/DabModulator.cpp:214-277): OfdmGeneratorDEXTER -> fixed-point
    GuardIntervalInserter -> FormatConverter(complexfix_wide, s16).
    Callable on the fetched [2, B, S, nb_carriers] int32 symbol array
    (Q1.14 values); returns packed i32 wire words [B, tf_samples]
    (s16 I/Q pairs, byte-identical to interleaved s16).
    """

    def __init__(self, mode_params, window_overlap: int, iio_module=None):
        self.p = mode_params
        self.window_overlap = int(window_overlap)
        self.accel = DexterFftAccelerator(
            mode_params.nb_symbols + 1, mode_params.nb_carriers,
            mode_params.spacing, iio_module=iio_module)
        self.num_clipped = 0          # last batch (RC parity with the
        self.num_clipped_total = 0    # other paths) / lifetime total

    def __call__(self, symbols: np.ndarray) -> np.ndarray:
        p = self.p
        two, B, S, C = symbols.shape
        assert two == 2 and C == p.nb_carriers, symbols.shape
        wide_re = np.empty((B, S, p.spacing), np.int32)
        wide_im = np.empty((B, S, p.spacing), np.int32)
        for b in range(B):
            wide_re[b], wide_im[b] = self.accel.process(
                symbols[0, b], symbols[1, b])
        if self.window_overlap:
            gi = guard_interval_windowed_wide(
                (wide_re, wide_im), p.null_size, p.sym_size,
                self.window_overlap)
        else:
            gi = guard_interval_unwindowed_wide(
                (wide_re, wide_im), p.null_size, p.sym_size)
        s16, n_clipped = format_convert_wide_s16(*gi)
        self.num_clipped = n_clipped
        self.num_clipped_total += n_clipped
        words = (s16[..., 1].astype(np.int32) << 16) \
            | (s16[..., 0].astype(np.int32) & 0xFFFF)
        return words
