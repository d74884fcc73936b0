"""The whole tracking step's share of the card's bf16 dense peak: the FLOPs
that the traced window's calls needed by the algorithm (`roofline/step.py`:
XMem's encoders, decoder and reads, SAM's encodes and decodes, at each
call's shapes, independent of how the program computes them), over the
traced window, over the peak."""

# the consolidation's probe counts the long-term slots that the read's probe reads
LAYERS = ("xmem_step", "memory_read", "memory_consolidation", "sam_encode", "sam_decoder")


def read(tv):
    if not tv.frames or tv.peaks is None or not tv.probes("xmem_step"):
        return None
    st = tv.step
    flops = sum(st.xmem(p["hw"][0], p["hw"][1], p["objects"], p["memory_frame"])
                for p in tv.probes("xmem_step"))
    flops += sum(st.read(p["q"], p["m"], p["objects"]) for p in tv.probes("memory_read"))
    flops += sum(p["frames"] * st.encode(p["grid"]) for p in tv.probes("sam_encode"))
    flops += sum(st.decode(p["packs"], p["points"], p["grid"], p["mask"], p["frames"])
                 for p in tv.probes("sam_decoder"))
    return 100.0 * flops / tv.window_s / tv.peaks["bf16_dense_flops_per_s"]
