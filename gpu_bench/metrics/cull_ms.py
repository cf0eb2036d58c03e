"""The mean time of a remesh's culling render (the loop's
``intensity_seconds``: render_intensity through K3), in ms."""


def read(ctx):
    ms = [r["intensity_seconds"] * 1e3 for it in ctx.iterations
          for r in it.get("remeshes", ())]
    return sum(ms) / len(ms) if ms else None
