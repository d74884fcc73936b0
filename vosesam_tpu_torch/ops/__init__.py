"""Image, aggregation, morphology and memory-attention ops (port of vosesam_tpu.ops)."""
