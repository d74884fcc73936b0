"""Host time inside the program's `track.download` spans (the host blocked
on the card, then the copy to pageable memory), per frame delivered."""

# the program's own spans: no wrapped range
LAYERS = ()


def read(tv):
    t = tv.layer_host_s("track.download")
    if not tv.frames or t <= 0:
        return None
    return t * 1e3 / tv.frames
