"""train_steps_per_s.f32: train_flash_f32's steps (float32 blocks, a
spread of their own) completed in the window, each ended synchronised,
over the window's seconds (host clock)."""


def read(run):
    if run.kind != "train" or not run.done:
        return None
    return run.done / run.window_s
