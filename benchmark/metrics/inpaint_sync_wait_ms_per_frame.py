"""Host time inside the program's `inpaint.download` spans (the host blocked
on the card until the video's composite is done, then the uint8 copy to
pageable memory), per inpainted frame delivered."""

# the program's own spans: no wrapped range
LAYERS = ()


def read(tv):
    t = tv.layer_host_s("inpaint.download")
    if not tv.frames or t <= 0:
        return None
    return t * 1e3 / tv.frames
