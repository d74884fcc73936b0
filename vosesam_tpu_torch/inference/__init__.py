"""Per-frame inference (port of vosesam_tpu.inference)."""
