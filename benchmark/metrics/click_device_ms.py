"""Device time of a click's decode, mask selection and paint
(`click_full`: the prompt encoder and the HQ mask decoder, once or twice),
per click."""

LAYERS = ("click",)


def read(tv):
    n, t = tv.layer_calls("click"), tv.layer_device_s("click")
    if not n or t <= 0:
        return None
    return t * 1e3 / n
