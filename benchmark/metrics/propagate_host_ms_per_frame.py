"""Host time inside the program's `e2fgvi.propagate` spans (the host issuing
the second-order deformable propagation, backward and forward), per
inpainted frame delivered."""

# the program's own spans: no wrapped range
LAYERS = ()


def read(tv):
    t = tv.layer_host_s("e2fgvi.propagate")
    if not tv.frames or t <= 0:
        return None
    return t * 1e3 / tv.frames
