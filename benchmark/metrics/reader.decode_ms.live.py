"""The stream reader's decode a batch (ModRuntime.timings['read_decode_s']: EDI AF/TAG decode with its CRCs and the rebuild into ETI, or ETI-over-TCP framing; the socket's wait left out), ms.
Over the traced stretch: the counter's increase over the steps issued;
nothing where the program has no such counter."""


def read(t, cell):
    v = t.timings.get("read_decode_s")
    if v is None or t.batches == 0:
        return None
    return 1e3 * v / t.batches
