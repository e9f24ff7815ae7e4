"""bounce_Mlanes.batch: the lanes of every bounce a frame, in millions
(the sum of width x bounces of ``integrator.BOUNCE_WIDTHS``, settled,
over the frames the traced window rendered)."""


def read(run):
    if run["mode"] != "batch" or not run["rendered"] or not run["bounce_widths"]:
        return None
    return sum(w * n for w, n in run["bounce_widths"].items()) / run["rendered"] / 1e6
