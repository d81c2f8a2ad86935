"""Modulator.modulate's host time a batch (ModRuntime.timings['modulate_s']), ms.
Over the traced stretch: the counter's increase over the steps issued."""


def read(t, cell):
    if t.batches == 0:
        return None
    return 1e3 * t.timings["modulate_s"] / t.batches
