"""Visualization (port of vosesam_tpu.viz)."""
