"""The device's idle share of the window's traced slice (its last seconds
but one, under load), in %: 1 minus the union of device activity over the
slice's wall."""


def read(run):
    sl = run.window.trace
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s) if sl is not None else None
