"""An encode's frames and token grid (from its result's shape)."""


def probe(args, kwargs, out, store):
    e = out.embedding
    return {"frames": int(e.shape[0]), "grid": (int(e.shape[1]), int(e.shape[2]))}
