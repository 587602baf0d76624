"""Device milliseconds a trial spends in copies between host and card:
x0 in, the plan's per-level constants in, x_final, node sends and the
counters out (every ``gpu_memcpy`` operation of the traced calls), over
the trials traced; nothing where the traced calls copy nothing."""


def read(ctx):
    if ctx.trace is None:
        return None
    copies = ctx.trace.device_time_s(lambda n: True, cats=("gpu_memcpy",))
    return 1e3 * copies / ctx.trials if copies > 0 else None
