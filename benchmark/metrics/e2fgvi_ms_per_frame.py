"""Device time inside the E2FGVI generator's ranges (`generator_forward`:
flows, encoder, propagation, focal transformer, decoder), per inpainted
frame delivered."""

LAYERS = ("e2fgvi_generator",)


def read(tv):
    t = tv.layer_device_s("e2fgvi_generator")
    if not tv.frames or t <= 0:
        return None
    return t * 1e3 / tv.frames
