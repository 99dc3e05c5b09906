"""idle_share (device): the share of the profiled stretch in which no
device operation ran, in %."""
from portbench import tracing


def read(r):
    st = r.stretch
    if st is None or not st.ops or st.t1_ns <= st.t0_ns:
        return None
    window = (st.t1_ns - st.t0_ns) / 1e9
    return (1.0 - tracing.busy_seconds(st) / window) * 100.0
