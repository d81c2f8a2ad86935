"""The card's busy time a batch: the union of its kernels, copies and
fills over the traced stretch, over the steps issued there, ms."""


def read(t, cell):
    if t.batches == 0 or t.busy_s <= 0:
        return None
    return 1e3 * t.busy_s / t.batches
