"""``hot_gather``'s share of its roofline: the least time of a period's
three launches (their bytes over HBM, all points of a batched launch)
over their measured device time in the traced stretch, in percent."""
from simbench.metrics.kernel_bytes import (
    HBM_BYTES_PER_S, hot_gather_bytes, hot_gather_calls,
)

UNIT = "%"
LAYER = "kernels"
MOVES = "windows_per_s"
SOURCE = "device_trace"


def read(run):
    st = run.stretch
    if st is None or not st.periods:
        return None
    n, s = st.kernel("hot_gather_kernel")
    calls = hot_gather_calls(run.rack)
    if not s or n != len(calls) * st.periods:
        return None
    least = (sum(hot_gather_bytes(*c) for c in calls) * run.points
             / HBM_BYTES_PER_S)
    return 100.0 * least / (s / st.periods)
