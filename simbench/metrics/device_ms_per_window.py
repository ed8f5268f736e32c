"""Device time a simulator window (a fleet window in a fleet): the union
of the device's intervals in the traced stretch over its windows."""
UNIT = "ms"
LAYER = "device"
MOVES = "windows_per_s"
SOURCE = "device_trace"


def read(run):
    st = run.stretch
    if st is None or not st.windows or not st.busy_s:
        return None
    return st.busy_s * 1e3 / st.windows
