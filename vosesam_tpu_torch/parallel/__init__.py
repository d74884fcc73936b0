"""Multi-device: data-parallel evaluation, inpainting and training over
`torch.distributed` process groups (port of `vosesam_tpu/parallel/`)."""
