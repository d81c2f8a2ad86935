"""K4, the KISS fixed-point inverse transform: the least time the card
could take for the work of one step of the cell over the median device
time of its launches in the trace (roofline_kiss.share), %.  Nothing
where the step launches no K4."""
import roofline_kiss


def read(t, cell):
    return roofline_kiss.share("kiss_ifft_kernel", t, cell)
