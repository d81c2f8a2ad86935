"""ctypes bindings for the native C++ host library, native/dabmod_native.cpp
(the port's copy of dabmod_tpu/native.py's bindings and wrappers).

The library holds the host-side hot paths around the signal chain: the
ETI(NI) batch parse (src/EtiReader.cpp), CRC16-CCITT (lib/crc.c), RS(255,207)
encode and errors-and-erasures decode for EDI PFT (lib/fec/decode_rs.h),
and saturating s16/u8/s8 conversion with clip counts
(src/FormatConverter.cpp).  io/rs.py's decode and io/outputs.py's
serialize_iq_count try it first, as dabmod_tpu's do.  Unlike dabmod_tpu's,
the port's eti.parse_eti_frames stays on NumPy: this binding's parse,
with the batch made from its result, measured slower than it (PERF.md).

It is built with g++ at first use (get_lib), never at import, into
dabmod_tpu_torch/_build/ (listed in .gitignore): the library's name
carries a hash of the source and the flags, the source is only read, and
a build writes a temporary file that it renames into place under a file
lock, so processes that start at once (pytest-xdist workers, ranks) build
it once.  Where g++ is absent or fails, or DABMOD_NO_NATIVE=1, get_lib
returns None and every wrapper returns None: the callers then take their
NumPy branches, which give the same results.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger("dabmod_tpu_torch.native")

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "dabmod_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None
_load_attempted = False
_LOCK = threading.Lock()


def library_path() -> str:
    """The built library, named by the hash of its source and flags."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0")
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libdabmod_native-{digest.hexdigest()[:12]}.so")


def _build() -> str | None:
    """The library's path, built first if it is not there; None (logged)
    where it cannot be built."""
    try:
        out = library_path()
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(out):     # another process built it
                tmp = f"{out}.{os.getpid()}.tmp"
                subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE],
                               check=True, capture_output=True)
                os.replace(tmp, out)
        return out
    except (OSError, subprocess.CalledProcessError) as e:
        log.warning("native build failed (%s); using NumPy fallbacks", e)
        return None


def get_lib():
    """The loaded library, built at the first call; None where it cannot
    be built or DABMOD_NO_NATIVE=1 (decided once a process)."""
    global _lib, _load_attempted
    with _LOCK:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        if os.environ.get("DABMOD_NO_NATIVE") == "1":
            return None
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")

        lib.dab_crc16.restype = ctypes.c_uint16
        lib.dab_crc16.argtypes = [u8p, ctypes.c_size_t]

        lib.dab_parse_eti_batch.restype = ctypes.c_int
        lib.dab_parse_eti_batch.argtypes = [
            u8p, ctypes.c_size_t, u8p, u8p, u16p, u32p,
            u8p, ctypes.c_size_t, u8p, ctypes.c_size_t,
            u16p, ctypes.POINTER(ctypes.c_int)]

        lib.dab_rs_decode.restype = ctypes.c_int
        lib.dab_rs_decode.argtypes = [u8p, i32p, ctypes.c_int]

        lib.dab_rs_encode.restype = None
        lib.dab_rs_encode.argtypes = [u8p, u8p]

        for name, outp in (("dab_convert_s16", i16p), ("dab_convert_u8", u8p),
                           ("dab_convert_s8", i8p)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_size_t
            fn.argtypes = [f32p, outp, ctypes.c_size_t]

        _lib = lib
        return _lib


# ---------------------------------------------------------------------------
# High-level wrappers: each returns None where the library is unavailable
# ---------------------------------------------------------------------------


def crc16(data: bytes | np.ndarray) -> int | None:
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(bytes(data), np.uint8) if not isinstance(
        data, np.ndarray) else np.ascontiguousarray(data, np.uint8)
    return int(lib.dab_crc16(buf, buf.size))


def rs_decode(block: np.ndarray, erasures=None) -> int | None:
    """Errors-and-erasures decode of a contiguous 255-byte uint8 block in
    place: the corrected symbols, or -1.  The erasure positions are taken
    as the NumPy decoder takes them (those within the block, once each):
    the C decoder indexes its tables with them unchecked."""
    lib = get_lib()
    if lib is None:
        return None
    if (block.dtype != np.uint8 or block.size != 255
            or not block.flags.c_contiguous):
        raise ValueError(f"an RS block is 255 contiguous uint8 bytes, not "
                         f"{block.size} {block.dtype}")
    given = () if erasures is None else erasures
    eras = np.array(sorted({int(e) for e in given if 0 <= e < 255}),
                    np.int32)
    return int(lib.dab_rs_decode(block, eras, eras.size))


def rs_encode(data: np.ndarray) -> np.ndarray | None:
    """The 48 parity bytes of 207 data bytes."""
    lib = get_lib()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.uint8).reshape(-1)
    if data.size != 207:
        raise ValueError(f"RS(255, 207) encodes 207 bytes, not {data.size}")
    parity = np.zeros(48, np.uint8)
    lib.dab_rs_encode(data, parity)
    return parity


def parse_eti_batch(raw: np.ndarray):
    """Native batch ETI parse of [T, 6144] frames.  None where the library
    is unavailable, or where the first frame's sub-channel table does not
    fit the C parser's buffers (more than 64 streams, or payloads that run
    past the frame: the parser does not check, and the NumPy branch takes
    such frames as it always has); raises eti.EtiError (FICF clear, return
    code -1) or eti.EnsembleReconfigured (the STC (-2) or NST (-3) changed
    inside the batch, checked before a frame's payload is read); else
    (mid, [(scid, sad, stl, tpl)...], fct, fp, mnsc, tist_pps, fic,
    sub-channel views)."""
    lib = get_lib()
    if lib is None:
        return None
    from .eti import ETI_NI_FRAME, EnsembleReconfigured, EtiError
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.ndim != 2 or raw.shape[1] != ETI_NI_FRAME:
        raise EtiError(f"expected [T, {ETI_NI_FRAME}] raw frames, got "
                       f"{raw.shape}")
    T = raw.shape[0]
    mid = int((raw[0, 6] >> 3) & 0x3)
    fic_len = 128 if mid == 3 else 96
    n_st = int(raw[0, 5]) & 0x7F
    stc0 = raw[0, 8:8 + 4 * n_st].reshape(n_st, 4).astype(np.int64)
    payload = int((((stc0[:, 2] & 0x3) << 8) | stc0[:, 3]).sum()) * 8
    if n_st > 64 or 8 + 4 * n_st + 4 + fic_len + payload + 8 > ETI_NI_FRAME:
        return None
    fct = np.zeros(T, np.uint8)
    fp = np.zeros(T, np.uint8)
    mnsc = np.zeros(T, np.uint16)
    tist = np.zeros(T, np.uint32)
    fic = np.zeros((T, fic_len), np.uint8)
    subch_stride = 6144  # upper bound of per-frame payload
    subch = np.zeros((T, subch_stride), np.uint8)
    stc = np.zeros(64 * 4, np.uint16)
    nst = ctypes.c_int(0)
    ret = lib.dab_parse_eti_batch(raw, T, fct, fp, mnsc, tist, fic, fic_len,
                                  subch, subch_stride, stc, ctypes.byref(nst))
    if ret == -1:
        raise EtiError("FIC must be present to modulate")
    if ret in (-2, -3):
        raise EnsembleReconfigured("sub-channel table changed inside batch")
    if ret != 0:
        raise EtiError(f"native ETI parse error {ret}")
    n = nst.value
    stc_list = [(int(stc[4 * i]), int(stc[4 * i + 1]), int(stc[4 * i + 2]),
                 int(stc[4 * i + 3])) for i in range(n)]
    subch_list = []
    off = 0
    for (_, _, stl, _) in stc_list:
        size = stl * 8
        subch_list.append(subch[:, off:off + size])
        off += size
    return mid, stc_list, fct, fp, mnsc, tist, fic, subch_list


def convert(interleaved: np.ndarray, fmt: str):
    """Saturating conversion of interleaved f32 samples to s16, u8 (offset
    128) or s8, truncating toward zero: (output array, samples clipped),
    or None where the library is unavailable or fmt is another format."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(interleaved, np.float32).reshape(-1)
    if fmt == "s16":
        out = np.empty(x.size, np.int16)
        n = lib.dab_convert_s16(x, out, x.size)
    elif fmt == "u8":
        out = np.empty(x.size, np.uint8)
        n = lib.dab_convert_u8(x, out, x.size)
    elif fmt == "s8":
        out = np.empty(x.size, np.int8)
        n = lib.dab_convert_s8(x, out, x.size)
    else:
        return None
    return out, int(n)
