"""device_idle_share: 100 x (1 - busy / window) over the traced stretch:
busy is the union of the device's activity intervals in the profiler's
trace, averaged over the cards a cell uses."""


def read(rec, cell):
    tr = rec.trace
    if tr is None or tr.window_s <= 0.0 or tr.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
