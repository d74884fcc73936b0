"""XMem memory hierarchy (port of vosesam_tpu.memory)."""
