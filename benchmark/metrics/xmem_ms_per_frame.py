"""Device time inside the XMem step's ranges, per frame delivered."""

LAYERS = ("xmem_step",)


def read(tv):
    t = tv.layer_device_s("xmem_step")
    if not tv.frames or t <= 0:
        return None
    return t * 1e3 / tv.frames
