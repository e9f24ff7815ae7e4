"""program_launches.batch: the port's program launches a frame
(``graphs.STATS["launches"]``) over the traced frames."""


def read(run):
    if run["mode"] != "batch" or not run["frames"]:
        return None
    return run["program_launches"] / run["frames"]
