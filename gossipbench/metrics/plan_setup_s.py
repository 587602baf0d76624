"""Seconds of the host plan's set-up: `setup_plan` (rgg, plan build, or
the plan cache's load on a hit), by the host clock around the call."""


def read(ctx):
    return ctx.plan_setup_s
