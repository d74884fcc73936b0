"""Host time inside the program's `click.full` spans (the click's decodes, mask
selection and paint as the host issues them), per request."""

# the program's own spans: no wrapped range
LAYERS = ()


def read(tv):
    t = tv.layer_host_s("click.full")
    if not tv.requests or t <= 0:
        return None
    return t * 1e3 / tv.requests
