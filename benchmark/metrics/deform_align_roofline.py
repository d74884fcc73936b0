"""Kernel B6's share of its roofline: the least time the card could take
for the traced calls' bytes (`roofline/deform_align.py`: x, offsets and
mask read once, the patches written once) over the HBM peak, over the
device time inside the B6 wrapper's ranges."""

from roofline.deform_align import deform_bound_s

LAYERS = ("deform_align",)


def read(tv):
    t = tv.layer_device_s("deform_align")
    calls = tv.probes("deform_align")
    if t <= 0 or not calls or tv.peaks is None:
        return None
    bound = sum(deform_bound_s(p["b"], p["h"], p["w"], p["cin"], p["groups"],
                               tv.peaks["hbm_bytes_per_s"], p["itemsize"]) for p in calls)
    return 100.0 * bound / t
