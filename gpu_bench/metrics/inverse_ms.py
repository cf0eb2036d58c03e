"""The mean time of an iteration's inverse_render call (the chunk loop,
sampling, K1, K2 or the eager backward), span ended by a
synchronisation, in ms."""


def read(ctx):
    ms = [it["render_s"] * 1e3 for it in ctx.iterations if it["render_s"]]
    return sum(ms) / len(ms) if ms else None
