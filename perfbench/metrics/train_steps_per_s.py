"""train_steps_per_s: train steps completed in the window, each ended
synchronised, over the window's seconds (host clock)."""


def read(run):
    if run.kind != "train" or not run.done:
        return None
    return run.done / run.window_s
