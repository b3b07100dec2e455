"""collective_share: device time of the NCCL kernels (kernels/nccl.json)
over the traced stretch, in percent, averaged over the ranks."""

from portbench import counts


def read(rec, cell):
    tr = rec.trace
    if tr is None or tr.window_s <= 0.0:
        return None
    t = tr.device_s(counts.kernel(cell.root, "nccl")["names"])
    if t <= 0.0:
        return None
    return 100.0 * t / (tr.window_s * rec.ranks)
