"""Global attention's share of its roofline: the least time the card could
take for the global blocks' attention work (`roofline/attention.py`: the
rel-pos factors, q.k^T and p.v, the larger of operations over the bf16
peak and bytes over the HBM peak), over the device time inside the
global-attention ranges."""

from roofline.attention import global_attention_work

LAYERS = ("global_attention",)


def read(tv):
    t = tv.layer_device_s("global_attention")
    calls = tv.probes("global_attention")
    if t <= 0 or not calls or tv.peaks is None:
        return None
    bound = 0.0
    for p in calls:
        f, b = global_attention_work(p["b"], p["heads"], p["grid"][0], p["grid"][1], p["d"],
                                     p["itemsize"])
        bound += max(f / tv.peaks["bf16_dense_flops_per_s"], b / tv.peaks["hbm_bytes_per_s"])
    return 100.0 * bound / t
