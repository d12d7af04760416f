"""Gridpoint-years a second: sites times sim years of every block completed
in the window, over the window's wall time (host clock)."""


def read(ctx):
    if not ctx.block_s or not ctx.window_s:
        return None
    return len(ctx.block_s) * ctx.sites * ctx.sim_years / ctx.window_s
