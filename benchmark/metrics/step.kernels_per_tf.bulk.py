"""The card's kernels a TF: the device kernels of the traced stretch (its
copies and fills left out) over the TFs of the steps issued there.  It
reads how many kernels the captured step holds, which the int32 KISS
chain set at some 1,400 a 24-TF batch."""

# the names devtrace.kernel_of gives the profiler's copies and fills
# ("Memcpy DtoH (Device -> Pinned)", "Memset (Device)")
COPIES = frozenset({"HtoD", "DtoH", "DtoD", "HtoH", "PtoP", "Memset"})


def read(t, cell):
    if t.batches == 0:
        return None
    n = sum(len(v) for k, v in t.kernels.items() if k not in COPIES)
    if n == 0:
        return None
    return n / (t.batches * cell["batch_tf"])
