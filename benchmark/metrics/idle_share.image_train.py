"""Device: the traced window's share with no device operation running,
in % (the union of kernel, copy and set intervals against the window)."""


def read(run):
    return None if run.trace is None else run.trace.idle_share
