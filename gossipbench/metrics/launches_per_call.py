"""Device operations (kernels, copies, fills) a call launches: every
device operation in the profile of the traced calls, over the calls.
An exact count; a change that fuses or removes launches moves it."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return len(ctx.trace.device) / ctx.calls
