"""Device kernels launched a request in the traced part (profiler count,
copies and memsets left out): FPS's host loop launches ~6 a pick."""


def read(run):
    t = getattr(run, "trace", None)
    if run.kind != "serve" or not t or t["busy_s"] <= 0 \
            or not run.traced_done:
        return None
    return t["launches"] / run.traced_done
