"""bounce_live_pct.batch: the share of the bounces' lanes that entered them
alive, in % (the live lanes the bounce tests counted on the card,
``integrator.BOUNCE_LIVE``, over the width x bounces of
``integrator.BOUNCE_WIDTHS``, both settled after the traced window)."""

from benchmark.span_metrics import bounce_live_pct


def read(run):
    return bounce_live_pct(run, "batch")
