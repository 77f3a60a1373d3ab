"""setup_s: seconds from the process's start to the window's (imports, the
card's context, loading or building the kernels, the pool, the warm-up)."""


def read(run):
    return run["setup_s"]
