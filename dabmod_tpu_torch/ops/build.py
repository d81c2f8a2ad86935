"""Build the port's CUDA sources (ops/csrc/*.cu) into shared libraries with a
plain C interface, and load them with ctypes.

Each source compiles with its own nvcc run into dabmod_tpu_torch/_build/
(listed in .gitignore).  A library's file name carries a hash of its
source, of every header in csrc/ (*.cuh, which any source may include) and
of the flags, so an edited source or header builds anew and an unchanged
one is reused.  Nothing builds at import: the first launch of a kernel
builds its library, or a caller runs build() ahead of time, which starts
one nvcc per source, all at once.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)), "_build")
SOURCES = ("ofdm_ifft", "ofdm_cfr", "resample_poly", "kiss_ifft", "frontend")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, else from PATH, else the toolkit's default
    install prefix /usr/local/cuda (where PyTorch looks too)."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit or "
                       "put nvcc on PATH to build the port's CUDA kernels")


def library_path(name: str) -> str:
    """The library of csrc/<name>.cu, named by the hash of the source, the
    csrc/ headers and the flags."""
    digest = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in [os.path.join(CSRC_DIR, name + ".cu"), *headers]:
        digest.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(*names: str) -> list[str]:
    """Compile csrc/<name>.cu for each name (default: every source) unless
    it is built already, one nvcc process per source, all started
    together; returns the libraries' paths in the order of `names`.  Each
    compiler's output (with -Xptxas -v: registers and shared memory per
    kernel) is kept beside its library as <library>.log."""
    names = names or SOURCES
    outs = [library_path(name) for name in names]
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    running = []
    for name, out in zip(names, outs):
        if os.path.exists(out):
            continue
        nvcc = nvcc or find_nvcc()
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp,
             os.path.join(CSRC_DIR, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        running.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in running:
        log = proc.communicate()[0].decode(errors="replace")
        with open(out + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"CUDA build of {name}.cu failed (nvcc exit "
                          f"{proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)[0])
            _LIBS[name] = lib
        return lib


def launcher(name: str, symbol: str, n_pointers: int, *scalars):
    """The C launch function `symbol` of csrc/<name>.cu, declared as taking
    `n_pointers` device pointers, then the ctypes `scalars`, then the
    stream, and returning a CUDA error code (0 = launched).  Pointers and
    the stream are c_void_p: ctypes would pass a bare Python int as a
    32-bit int and cut it."""
    fn = getattr(load(name), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + list(scalars)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def query(name: str, symbol: str, n_out: int, *args: int) -> list[int]:
    """Call the C function `symbol`(int args..., int* out) of csrc/<name>.cu,
    which fills `n_out` ints and returns a CUDA error code; returns the
    ints.  The kernels' launch-shape queries take this form."""
    fn = getattr(load(name), symbol)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * n_out)()
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")
    return list(out)
