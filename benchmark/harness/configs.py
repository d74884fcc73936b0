"""A configuration file (`configs/<name>.json`) -> a `FrameworkConfig` of
the port or of the plain reference: both packages take the same field
names, so one file states one run for both."""

from __future__ import annotations

from types import ModuleType
from typing import Dict, Optional

MEMORY_KEYS = ("max_mid_term_frames", "min_mid_term_frames", "max_long_term_elements",
               "num_prototypes", "top_k", "mem_every", "deep_update_every",
               "enable_long_term", "enable_long_term_count_usage")
XMEM_KEYS = ("key_dim", "value_dim", "hidden_dim", "max_objects")
SAM_KEYS = ("model_type", "hq", "image_size", "patch_size", "prompt_embed_dim", "window_size")
REFINE_KEYS = ("use_refinement", "mode", "point_algorithm", "optimized", "score_gate",
               "min_region_area", "max_points", "max_neg_points")


def refines(cfg: Dict) -> bool:
    return bool(cfg.get("refinement", {}).get("use_refinement", False))


def framework(cfg: Dict, C: ModuleType, dtype: Optional[str] = None):
    """`C` is the `config` module of the port or of the reference."""
    xmem = C.XMemConfig(**{k: cfg["xmem"][k] for k in XMEM_KEYS if k in cfg["xmem"]})
    memory = C.MemoryConfig(**{k: cfg["memory"][k] for k in MEMORY_KEYS if k in cfg["memory"]})
    sam = C.SAMConfig()
    if "sam" in cfg:
        s = cfg["sam"]
        kw = {k: s[k] for k in SAM_KEYS if k in s}
        if "vit_dims" in s:      # a test's own encoder widths
            kw["vit_dims"] = tuple((n, d, dp, h, tuple(g)) for n, d, dp, h, g in s["vit_dims"])
        sam = C.SAMConfig(**kw)
        dims = sam.encoder_dims()
        want = (s["embed_dim"], s["depth"], s["num_heads"], tuple(s["global_attn_indexes"]))
        if tuple(dims) != want:
            raise ValueError(f"SAMConfig({s['model_type']}) has encoder dims {dims}, the "
                             f"configuration states {want}")
    ref = cfg.get("refinement", {})
    refinement = C.RefinementConfig(**{k: ref[k] for k in REFINE_KEYS if k in ref})
    return C.FrameworkConfig(xmem=xmem, memory=memory, sam=sam, refinement=refinement,
                             dtype=dtype or cfg["dtype"],
                             param_dtype=cfg.get("param_dtype", "float32"))
