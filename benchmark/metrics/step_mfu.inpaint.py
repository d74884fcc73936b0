"""The whole inpaint step's share of the card's bf16 dense peak: the FLOPs
that the traced window's generator calls needed by the algorithm
(`roofline/inpaint.py`: each window counted unpadded, at its valid frames,
independent of how the program computes it), over the traced window, over
the peak."""

LAYERS = ("e2fgvi_generator",)


def read(tv):
    calls = tv.probes("e2fgvi_generator")
    if not tv.frames or tv.peaks is None or not calls or tv.window_s <= 0:
        return None
    from harness import registry
    from roofline.inpaint import GeneratorFlops

    valid_counts = registry.probe("e2fgvi_generator").valid_counts
    count = GeneratorFlops(tv.cfg)
    flops = sum(count.window(n, p["num_local"], p["h"], p["w"])
                for p in calls for n in valid_counts(p))
    return 100.0 * flops / tv.window_s / tv.peaks["bf16_dense_flops_per_s"]
