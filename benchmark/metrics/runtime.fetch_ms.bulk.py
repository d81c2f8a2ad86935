"""The fetch thread's host work a batch after the card (ModRuntime.timings['fetch_s']: the f32 interleave of the planes), ms.
Over the traced stretch: the counter's increase over the steps issued."""


def read(t, cell):
    if t.batches == 0:
        return None
    return 1e3 * t.timings["fetch_s"] / t.batches
