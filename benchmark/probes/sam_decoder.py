"""A SAM decode's prompt packs, points per pack, token grid, frames and
whether a mask prompt rides along."""


def probe(args, kwargs, out, store):
    emb, coords = args[1], args[2]
    mask = args[4] if len(args) > 4 else kwargs.get("mask_input")
    return {"packs": int(coords.shape[0]), "points": int(coords.shape[1]),
            "grid": (int(emb.embedding.shape[1]), int(emb.embedding.shape[2])),
            "mask": mask is not None, "frames": int(emb.embedding.shape[0])}
