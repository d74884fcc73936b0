"""Serving (port of vosesam_tpu.serve): the stdlib HTTP inference server."""
