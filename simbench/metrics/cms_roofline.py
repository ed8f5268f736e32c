"""``cms``'s share of its roofline: the least time of one launch (its
bytes over HBM, all points of a batched launch) over the measured device
time a launch in the traced stretch, in percent."""
from simbench.metrics.kernel_bytes import HBM_BYTES_PER_S, cms_bytes

UNIT = "%"
LAYER = "kernels"
MOVES = "windows_per_s"
SOURCE = "device_trace"


def read(run):
    if run.stretch is None:
        return None
    n, s = run.stretch.kernel("cms_kernel")
    if not n or not s:
        return None
    least = cms_bytes(run.rack) * run.points / HBM_BYTES_PER_S
    return 100.0 * least / (s / n)
