"""SAM / SAM-HQ (port of vosesam_tpu.models.sam)."""
