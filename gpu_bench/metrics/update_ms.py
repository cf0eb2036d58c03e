"""The mean time of an iteration outside its render and its remesh (the
smoothing, the loss, Adam_Modified, the loop's bookkeeping), from the
traced run's spans, each ended by a synchronisation, in ms."""


def read(ctx):
    ms = [(it["seconds"] - it["render_s"] - it["remesh_s"]) * 1e3
          for it in ctx.iterations]
    return sum(ms) / len(ms) if ms else None
