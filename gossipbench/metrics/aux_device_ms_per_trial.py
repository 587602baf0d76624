"""Device milliseconds a trial spends in the torch kernels of
attribution and promotion: the scatter-adds, gathers, index arithmetic
and fills of `execute_plan` (every kernel of the traced calls whose
name is not a gossip kernel's; copies and memsets are not kernels and
are left out), over the trials traced."""

GOSSIP = ("sample_chunk_kernel", "sample_chunk_congestion",
          "pair_apply_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    other = ctx.trace.device_time_s(
        lambda n: not any(k in n for k in GOSSIP), cats=("kernel",))
    return 1e3 * other / ctx.trials
