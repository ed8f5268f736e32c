"""The device's idle share of the traced stretch: 1 - (union of the
device's intervals) / (the stretch's length), in percent."""
UNIT = "%"
LAYER = "device"
MOVES = "windows_per_s"
SOURCE = "device_trace"


def read(run):
    st = run.stretch
    if st is None or not st.window_s or not st.busy_s:
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
