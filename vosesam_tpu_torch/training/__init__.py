"""Training (port of vosesam_tpu.training): the XMem trainer and its clip
sampler."""
