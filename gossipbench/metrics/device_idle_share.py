"""The share of the traced calls' window in which nothing ran on the
device: 100 x (1 - the union of the device operations' intervals over
the window)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
