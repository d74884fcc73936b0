"""Host-side utilities (port of vosesam_tpu.utils)."""
