"""A generator call's windows: B, T, num_local, H, W, and each window's
valid slots (`frame_valid`, kept as the tensor it is and counted when the
metric reads it, so the probe makes the host wait on nothing)."""


def probe(args, kwargs, out, store):
    frames = args[1]
    num_local = args[2] if len(args) > 2 else kwargs["num_local"]
    valid = args[4] if len(args) > 4 else kwargs.get("frame_valid")
    b = int(frames.shape[0]) if frames.ndim == 5 else 1
    t, h, w = (int(s) for s in frames.shape[-4:-1])
    return {"b": b, "t": t, "num_local": int(num_local), "h": h, "w": w, "valid": valid}


def valid_counts(rec):
    """Each window's valid slot count: T where the call padded none."""
    v = rec["valid"]
    if v is None:
        return [rec["t"]] * rec["b"]
    return [int(n) for n in v.reshape(-1, rec["t"]).sum(-1).tolist()]
