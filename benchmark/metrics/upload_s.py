"""upload_s: the seconds of ``Scene.upload`` (the BVH and its streams, the
emissive tables, the sky, the copy to the card), timed around the call."""


def read(run):
    return run["spans"]["upload_s"]
