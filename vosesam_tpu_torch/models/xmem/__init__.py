"""XMem network (port of vosesam_tpu.models.xmem)."""
