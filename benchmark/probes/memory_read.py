"""A read's query tokens, valid memory slots (the working slots in use and
the long-term slots that consolidations wrote, both host counters) and the
objects it reads for."""


def probe(args, kwargs, out, store):
    state, qk, cfg = args[0], args[1], args[3]
    objects = cfg.live_objects or int(state.work.values.shape[0])
    lt = 0
    if cfg.enable_long_term:
        ref, n = store.get("lt_slots", {}).get(id(state.long), (None, 0))
        lt = n if ref is not None and ref() is state.long else 0
    return {"q": int(qk.shape[0] * qk.shape[1]), "m": int(state.work.count) + lt,
            "objects": int(objects)}
