"""Kernel records in the traced window per inpainted frame delivered."""

# the trace's kernel records alone
LAYERS = ()


def read(tv):
    if not tv.frames or not tv.kernels:
        return None
    return tv.kernels / tv.frames
