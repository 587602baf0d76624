"""The schedule draw's share of its roofline on the plain path (no
scenario, no cost model): the draw's least time, each chunk's larger of
its bytes over HBM and its hash operations over the card's int32 rate
(`gossipbench.work.gossip.draw_chunk`), over the device time of the
draw kernel in the traced calls."""

KERNELS = ("sample_chunk_kernel",)


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or ctx.priced:
        return None
    dev = ctx.trace.device_time_s(lambda n: any(k in n for k in KERNELS))
    if dev <= 0:
        return None
    bound = sum(ctx.least_s(b, ops, "int32")
                for w in ctx.work for b, ops in w["draw"])
    return 100.0 * bound / dev
