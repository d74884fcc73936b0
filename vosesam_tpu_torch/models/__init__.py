"""Network layers and models (port of vosesam_tpu.models)."""
