"""Device time of a session's `set_image` (the SAM encode at batch 1), per
call."""

LAYERS = ("set_image",)


def read(tv):
    n, t = tv.layer_calls("set_image"), tv.layer_device_s("set_image")
    if not n or t <= 0:
        return None
    return t * 1e3 / n
