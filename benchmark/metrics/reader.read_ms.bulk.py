"""The reader's time a batch (ModRuntime.timings['read_s']: a file read; sound for file input only), ms.
Over the traced stretch: the counter's increase over the steps issued."""


def read(t, cell):
    if t.batches == 0:
        return None
    return 1e3 * t.timings["read_s"] / t.batches
