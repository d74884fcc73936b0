"""Pipeline facades (port of vosesam_tpu.pipeline)."""
