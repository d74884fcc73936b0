"""Counts the long-term slots written into each video's memory (host-side:
consolidations times the prototype count, up to the capacity), for the
read's probe. Runs over the whole traced run, set-up included."""

import weakref

ALWAYS = True


def lt_slots(store, lt) -> int:
    ref, n = store.get("lt_slots", {}).get(id(lt), (None, 0))
    return n if ref is not None and ref() is lt else 0


def probe(args, kwargs, out, store):
    state, cfg, hw = args[0], args[1], args[2]
    work_cap = state.work.keys.shape[0]
    p = min(cfg.num_prototypes, work_cap - cfg.min_mid_term_frames * hw)
    lt = state.long
    n = min(lt.keys.shape[0], lt_slots(store, lt) + p)
    store.setdefault("lt_slots", {})[id(lt)] = (weakref.ref(lt), n)
    return {"prototypes": p}
