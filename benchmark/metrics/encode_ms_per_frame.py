"""Device time inside the SAM encode's ranges, per frame delivered."""

LAYERS = ("sam_encode",)


def read(tv):
    t = tv.layer_device_s("sam_encode")
    if not tv.frames or t <= 0:
        return None
    return t * 1e3 / tv.frames
