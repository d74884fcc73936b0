"""Host time inside the program's `xmem.step` spans (the key encoder, the
read, the decoder and the memory write as the host issues them), per frame
delivered."""

# the program's own spans: no wrapped range
LAYERS = ()


def read(tv):
    t = tv.layer_host_s("xmem.step")
    if not tv.frames or t <= 0:
        return None
    return t * 1e3 / tv.frames
