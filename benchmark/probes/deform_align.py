"""A B6 call's shapes: x (B, H, W, Cin) and the deform groups (the offsets'
last axis over 2 x 9)."""


def probe(args, kwargs, out, store):
    x, offset = args[0], args[1]
    b, h, w, cin = (int(s) for s in x.shape)
    return {"b": b, "h": h, "w": w, "cin": cin, "groups": int(offset.shape[-1]) // 18,
            "itemsize": x.element_size()}
