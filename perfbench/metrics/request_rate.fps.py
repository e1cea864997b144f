"""request_rate.fps: serve_fps's requests a second over their own time
(host clock), of the requests a traced run serves after its traced part,
since the profiler slows the traced ones down. A request here runs at
the host's launch rate (FPS's loop, ~214.6k launches), which swings with
the shared host's speed between runs by more than any bound allows, so
the cell's rate stands per layer, not end to end."""


def read(run):
    if run.kind != "serve" or not getattr(run, "trace", None):
        return None
    rest = run.latencies_s[run.traced_done:]
    return len(rest) / sum(rest) if rest else None
