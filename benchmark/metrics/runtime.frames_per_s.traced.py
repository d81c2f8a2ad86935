"""ETI frames that reached the sink in the traced run's window, over the
window (frames_per_s's arithmetic, cell.Cell.collect), frames/s.  The
window holds the profiled stretch and the profiler's stop, so it reads
below an untraced run; nothing where the loop is open."""


def read(t, cell):
    return cell.get("frames_per_s")
