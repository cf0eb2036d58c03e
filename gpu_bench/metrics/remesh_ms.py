"""The mean geomlib time of a remesh in the window (the loop's
``geomlib_seconds``: integration, El Topo role, isotropic remeshing),
in ms."""


def read(ctx):
    ms = [r["geomlib_seconds"] * 1e3 for it in ctx.iterations
          for r in it.get("remeshes", ())]
    return sum(ms) / len(ms) if ms else None
