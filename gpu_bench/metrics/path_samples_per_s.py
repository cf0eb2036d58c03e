"""Every path traced in the window, forward and backward (2*L*F*spt an
iteration, at that iteration's F and spt), over the window's seconds."""


def read(ctx):
    return sum(it["paths"] for it in ctx.iterations) / ctx.window_s
