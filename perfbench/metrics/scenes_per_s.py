"""scenes_per_s: requests completed in the window over the window's
seconds (host clock; closed loop, one client)."""


def read(run):
    if run.kind != "serve" or not run.done:
        return None
    return run.done / run.window_s
