"""Device time of the operations launched inside the program's
`e2fgvi.transformer` spans (soft split, the focal blocks, soft composite),
per inpainted frame delivered."""

# the program's own spans: no wrapped range
LAYERS = ()


def read(tv):
    t = tv.layer_device_s("e2fgvi.transformer")
    if not tv.frames or t <= 0:
        return None
    return t * 1e3 / tv.frames
