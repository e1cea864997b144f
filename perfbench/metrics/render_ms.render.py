"""Mean ms a request of the span around the render_images_stats that the
eval step looks up (render prep and K1) over the window."""
from perfbench.lib import readers


def read(run):
    return readers.span_mean_ms(run, "render") if run.kind == "serve" else None
