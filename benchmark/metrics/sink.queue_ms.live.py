"""The wait of the batch's TFs in SdrOutput's queue, from the writer's enqueue to the device thread's pop (ModRuntime.timings['sink_queue_s']), a batch, ms.
Over the traced stretch: the counter's increase over the steps issued;
nothing where the program has no such counter."""


def read(t, cell):
    v = t.timings.get("sink_queue_s")
    if v is None or t.batches == 0:
        return None
    return 1e3 * v / t.batches
