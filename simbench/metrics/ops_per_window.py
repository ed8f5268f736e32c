"""Device kernels a simulator window in the traced stretch (memcpy,
memset and the lead-in's spin kernels not counted)."""
UNIT = "ops"
LAYER = "window step"
MOVES = "windows_per_s"
SOURCE = "device_trace"


def read(run):
    st = run.stretch
    if st is None or not st.windows or not st.ops:
        return None
    return st.ops / st.windows
