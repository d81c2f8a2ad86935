"""Digital predistortion computation engine.

Port of the reference's DPDCE (python/dpdce.py, python/dpd/*): measure
timestamp-aligned TX/RX bursts from the SDR feedback port, extract binned
AM/AM + AM/PM statistics, fit the memoryless polynomial model by least
squares, and push the updated coefficients into the running modulator over
remote control.

The port's copy of dabmod_tpu/dpd/: host-only NumPy/SciPy, no tensor.
"""
from .measure import Measure  # noqa: F401
from .extract_statistic import ExtractStatistic  # noqa: F401
from .model_poly import Poly  # noqa: F401
from .model_lut import Lut  # noqa: F401
from .adapt import Adapt  # noqa: F401
from .globalconfig import DpdConfig  # noqa: F401
from .align import (  # noqa: F401
    SymbolAlign, align_tx_rx, coarse_align, phase_align, subsample_align)
from .mer import Mer  # noqa: F401
from .shoulders import MeasureShoulders  # noqa: F401
from .agc import RxAgc, TxAgc  # noqa: F401
from .heuristics import get_learning_rate, get_n_meas  # noqa: F401
