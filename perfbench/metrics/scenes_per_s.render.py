"""scenes_per_s.render: serve_render's requests (16 views at 512^2, with a
spread of their own) completed in the window over the window's seconds
(host clock; closed loop, one client)."""


def read(run):
    if run.kind != "serve" or not run.done:
        return None
    return run.done / run.window_s
