"""Host time inside the refinement's ranges (prompt geometry, SAM-HQ
decode, gate and composite, as issued by the host), per frame delivered."""

LAYERS = ("refinement",)


def read(tv):
    if not tv.frames or not tv.layer_calls("refinement"):
        return None
    return tv.layer_host_s("refinement") * 1e3 / tv.frames
