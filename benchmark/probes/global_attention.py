"""A global-attention call's shapes: q (B, heads, N, D), the token grid."""


def probe(args, kwargs, out, store):
    q = args[0]
    grid = args[5] if len(args) > 5 else kwargs["grid_hw"]
    return {"b": int(q.shape[0]), "heads": int(q.shape[1]), "d": int(q.shape[3]),
            "grid": (int(grid[0]), int(grid[1])), "itemsize": q.element_size()}
