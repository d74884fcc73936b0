"""Host time inside the program's `click.download` spans (the host blocked
on the card, then the mask, logit and painted frame copied to the host), per
request."""

# the program's own spans: no wrapped range
LAYERS = ()


def read(tv):
    t = tv.layer_host_s("click.download")
    if not tv.requests or t <= 0:
        return None
    return t * 1e3 / tv.requests
