"""Plain reference transforms on (re, im) planes (port of
dabmod_tpu/ops/fft.py).

The transform is unnormalised, matching FFTW_BACKWARD
(ref: src/OfdmGenerator.cpp:109-111).  torch.fft.ifft scales by 1/N by
default, so it is called with norm="forward", which puts the 1/N on the
forward side and leaves the inverse unscaled; the forward transform (CFR's
FFTW_FORWARD) is called with norm="backward", which leaves it unscaled.

Precision: dabmod_tpu maps `fft_precision` to the TPU's matmul passes
(default = 1-pass bf16, high = 3-pass, highest = 6-pass; its fft.py:26-37).
The port computes every transform in fp32 arithmetic for every value --
the hand-written OFDM kernel (ops/ofdm_kernel.py) and these references
alike -- which is at least as accurate as `high`.  Tensor-core TF32 or
3xTF32 variants are a later performance step.
"""
from __future__ import annotations

import torch

PRECISIONS = ("default", "high", "highest")


def set_precision(name: str) -> None:
    """Accept a dabmod_tpu `fft_precision` name.  Every value computes in
    fp32 here (see the module docstring); unknown names raise."""
    if name not in PRECISIONS:
        raise ValueError(f"unknown fft_precision {name!r}; "
                         f"expected one of {PRECISIONS}")


def fft_planes(x):
    """Unnormalised forward DFT (FFTW_FORWARD) on (re, im) planes."""
    z = torch.fft.fft(torch.complex(x[0], x[1]), norm="backward")
    return z.real.contiguous(), z.imag.contiguous()


def ifft_planes(x):
    """Unnormalised backward DFT (FFTW_BACKWARD) on (re, im) planes."""
    z = torch.fft.ifft(torch.complex(x[0], x[1]), norm="forward")
    return z.real.contiguous(), z.imag.contiguous()
