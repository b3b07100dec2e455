"""trace_roofline: the bound time of kernels/trace.json's work over its device
time in the traced stretch, in percent (counts.py)."""

from portbench import counts


def read(rec, cell):
    return counts.roofline_pct(rec, cell.root, "trace")
