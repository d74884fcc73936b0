"""The memory read's share of its roofline: the least time the card could
take for the reads' work over the valid slots these inputs need
(`roofline/memory_read.py`), over the device time of everything inside the
read's ranges."""

from roofline.memory_read import read_work

# the consolidation's probe counts the long-term slots that the read's probe reads
LAYERS = ("memory_read", "memory_consolidation")


def read(tv):
    t = tv.layer_device_s("memory_read")
    calls = tv.probes("memory_read")
    if t <= 0 or not calls or tv.peaks is None:
        return None
    x, mem = tv.cfg["xmem"], tv.cfg["memory"]
    bound = 0.0
    for p in calls:
        f, b = read_work(p["q"], p["m"], x["key_dim"], x["value_dim"], p["objects"],
                         mem["top_k"], 2)
        bound += max(f / tv.peaks["bf16_dense_flops_per_s"], b / tv.peaks["hbm_bytes_per_s"])
    return 100.0 * bound / t
