"""Host time inside the program's `e2fgvi.flow` spans (the host issuing
SPyNet's pyramids and the flows' resizes), per inpainted frame delivered."""

# the program's own spans: no wrapped range
LAYERS = ()


def read(tv):
    t = tv.layer_host_s("e2fgvi.flow")
    if not tv.frames or t <= 0:
        return None
    return t * 1e3 / tv.frames
