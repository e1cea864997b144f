"""setup_s: seconds from the process's start to the end of the warm-up
(host clock): imports, the kernels' load (and build on a first run), the
seeded weights, the pool and its ground truth, the raster budgets, the
warm-up requests or the checked steps."""


def read(run):
    return run.setup_s
