"""The main thread's parse a batch (ModRuntime.timings['parse_s']: ETI parse, FCT continuity, timestamps, FIC decode), ms.
Over the traced stretch: the counter's increase over the steps issued;
nothing where the program has no such span."""


def read(t, cell):
    v = t.timings.get("parse_s")
    if v is None or t.batches == 0:
        return None
    return 1e3 * v / t.batches
