"""XMem's memory schedule at a given frame count, counted from the
algorithm: a frozen copy of the schedule arithmetic of the port bench's
`soak` (`vosesam_tpu_torch/bench.py` at the commit that added this
benchmark). A memory frame every `mem_every` frames from frame 0; the
working memory holds `max_mid_term_frames` frames of HW tokens and, when
full, consolidates down to `min_mid_term_frames` frames; each
consolidation writes `num_prototypes` long-term slots, and the ones past
the long-term capacity overwrite (evict) live slots.
"""

from __future__ import annotations

from typing import Dict


def tokens(h: int, w: int) -> int:
    """Key-map tokens of an (h, w) frame (stride 16, padded up)."""
    return (-(-h // 16)) * (-(-w // 16))


def memory_schedule(n_frames: int, h: int, w: int, memory: Dict) -> Dict[str, int]:
    """After `n_frames` frames of one video (frame 0 annotated): memory
    adds, consolidations, eviction cycles, long-term slots in use, working
    slots in use."""
    hw = tokens(h, w)
    cw = memory["max_mid_term_frames"] * hw
    mw = memory["min_mid_term_frames"] * hw
    lt_cap = memory["max_long_term_elements"]
    p = min(memory["num_prototypes"], cw - mw)
    adds = (n_frames - 1) // memory["mem_every"] + 1 if n_frames > 0 else 0
    max_adds = cw // hw
    consols = 0 if adds < max_adds else 1 + (adds - max_adds) * hw // (cw - mw)
    evictions = max(0, consols - lt_cap // p)
    return {"adds": adds, "consolidations": consols, "eviction_cycles": evictions,
            "lt_valid": min(lt_cap, consols * p),
            "work_count": adds * hw - consols * (cw - mw)}


def consolidates_at(frame: int, memory: Dict) -> bool:
    """Whether tracking frame `frame` (0-based) of a video adds a memory
    frame that fills the working memory, which then consolidates."""
    every = memory["mem_every"]
    if frame % every:
        return False
    add = frame // every + 1
    first = memory["max_mid_term_frames"]
    step = memory["max_mid_term_frames"] - memory["min_mid_term_frames"]
    return add >= first and (add - first) % step == 0
