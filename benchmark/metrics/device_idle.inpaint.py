"""The card's idle share of the traced window: 100 x (1 - busy / window),
busy being the union of the device's operation intervals."""

# the ranges that the breakdown's idle gaps are attributed to (besides the
# program's own `inpaint.*` and `e2fgvi.*` spans)
LAYERS = ("e2fgvi_generator", "deform_align")


def read(tv):
    if tv.window_s <= 0 or tv.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tv.busy_s / tv.window_s)
