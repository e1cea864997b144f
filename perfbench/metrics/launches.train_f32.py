"""Device kernels launched a float32 step in the traced part (profiler
count, copies and memsets left out)."""


def read(run):
    t = getattr(run, "trace", None)
    if run.kind != "train" or not t or t["busy_s"] <= 0 \
            or not run.traced_done:
        return None
    return t["launches"] / run.traced_done
