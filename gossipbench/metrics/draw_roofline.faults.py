"""The schedule draw's share of its roofline under a failure scenario
and a cost model: the least time of the draw with the scenario's flags
and the priced streams (`gossipbench.work.gossip.draw_chunk` with
`scenario` and `cost`), over the device time of the draw kernel and the
congestion kernel in the traced calls."""

KERNELS = ("sample_chunk_kernel", "sample_chunk_congestion")


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.priced:
        return None
    dev = ctx.trace.device_time_s(lambda n: any(k in n for k in KERNELS))
    if dev <= 0:
        return None
    bound = sum(ctx.least_s(b, ops, "int32")
                for w in ctx.work for b, ops in w["draw"])
    return 100.0 * bound / dev
