"""K1, the inverse transform: the least time the card could take for the work of one step
of the cell over the median device time of its launches in the trace
(roofline.share), %."""
import roofline


def read(t, cell):
    return roofline.share("ofdm_ifft", "ofdm_ifft_kernel", t, cell)
