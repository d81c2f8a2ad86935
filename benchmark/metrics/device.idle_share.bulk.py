"""The card's idle share of the traced stretch: 1 - the union of its
kernels, copies and fills over the stretch's host wall time, %."""


def read(t, cell):
    if t.wall_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.wall_s)
