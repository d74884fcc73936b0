"""Typed configuration tree (the PyTorch port's own copy of
``vosesam_tpu/config.py``; the port imports nothing from the JAX package).

Replaces the reference's three uncoordinated config layers (YAML knobs in
``tracker/config/config.yaml`` + ``inpainter/config/config.yaml``, runtime-arg
nested dicts in the notebooks, and argparse in ``track_anything.py:84-95``)
with one frozen dataclass tree. Field names and defaults are those of the
JAX package, so one config value means the same run in both packages; knobs
that only steer TPU code paths (tile sizes, ``top_k_approx``) are kept for
parity and documented where the port reads them.

``FrameworkConfig.dtype="bfloat16"`` means bf16 activations with fp32
parameters on the card (every layer casts its fp32 weights to the
activation dtype); CPU tests use ``dtype="float32"``.

Reference parity notes (file:line point into the original Track-Anything sources):
  - XMem memory knobs: tracker/config/config.yaml:1-15
  - refinement modes: tracker/base_tracker.py:56-64
  - point algorithms: tracker/base_tracker.py:66-71 (C / CP / CPS)
  - optimized score gate (0.94): tracker/base_tracker.py:954-958
  - inpainter knobs: inpainter/config/config.yaml:1-7
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# The 10 SAM refinement prompt modes (tracker/base_tracker.py:56-64).
REFINEMENT_MODES: Tuple[str, ...] = (
    "bbox",
    "point",
    "both",
    "both_neg",
    "mask",
    "mask_bbox",
    "mask_pos",
    "mask_bbox_pos",
    "mask_bbox_neg",
    "mask_bbox_pos_neg",
)

# Point-generation algorithms (tracker/base_tracker.py:66-71).
POINT_ALGORITHMS: Tuple[str, ...] = ("C", "CP", "CPS")


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """XMem memory-hierarchy knobs (tracker/config/config.yaml:1-15).

    Like the JAX package, the port replaces dynamically growing
    concat-tensors with fixed-capacity arenas, so every buffer is allocated
    once per video.
    """

    max_mid_term_frames: int = 10      # config.yaml:4
    min_mid_term_frames: int = 5       # config.yaml:5
    max_long_term_elements: int = 1000  # config.yaml:6
    num_prototypes: int = 128          # config.yaml:7
    top_k: int = 30                    # config.yaml:8
    # JAX-only opt-in (lax.approx_max_k, a TPU instruction); the port
    # raises NotImplementedError when it is set.
    top_k_approx: bool = False
    # Fused read (exact top-k threshold -> softmax -> readout, usage
    # side-output; the CUDA kernel in ops/kernels/memory_read.py) instead of
    # the plain chain that materializes the (O, Q, M) affinity.
    fused_read: bool = True
    # Static live-object hint: only the first `live_objects` rows of the
    # (max_objects, ...) value arenas are live AND their validity rows are
    # identical — true whenever every object was registered before any
    # memory was committed (add_memory broadcasts one validity row,
    # manager.py:161; consolidation/eviction act on shared slots).
    # The read path then slices the arenas to this count and runs the
    # shared-validity fused kernel (one threshold/exp pass for all objects,
    # ops/kernels/memory_read.py:fused_memory_read_shared). Outputs are
    # bit-identical: dead rows produce zero readout/usage by construction.
    # Tracker sets this automatically from its MaskMapper and clears it if
    # an object is added mid-video. None = no assumption (full arenas).
    live_objects: Optional[int] = None
    mem_every: int = 5                 # config.yaml:9
    deep_update_every: int = -1        # config.yaml:10 (-1: sync with mem frames)
    enable_long_term: bool = True      # config.yaml:14
    enable_long_term_count_usage: bool = True  # config.yaml:15

    def work_capacity(self, hw: int) -> int:
        """Static working-memory slot capacity for a given key-map size HW.

        Reference grows work memory to ``max_mid_term_frames`` frames worth
        of tokens before consolidating (memory_manager.py:184-190);
        memory/rings.py allocates exactly this and consolidates on the add
        that would overflow.
        """
        return self.max_mid_term_frames * hw

    def min_work_elements(self, hw: int) -> int:
        return self.min_mid_term_frames * hw


@dataclasses.dataclass(frozen=True)
class XMemConfig:
    """XMem architecture dims.

    The reference infers these from checkpoint weight shapes
    (tracker/model/network.py:134-182); these defaults are the XMem-s012
    values (C^k=64, C^v=512, C^h=64).
    """

    key_dim: int = 64
    value_dim: int = 512
    hidden_dim: int = 64   # 0 disables the hidden state/GRUs
    max_objects: int = 8   # static object-axis padding (reference: dynamic N)
    single_object: bool = False

    @property
    def use_hidden(self) -> bool:
        return self.hidden_dim > 0


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    """SAM / SAM-HQ architecture (mirrors segment_anything's build_sam).

    The reference selects SAM vs SAM-HQ by installing a different package in a
    different venv (README.md:93-131, app.py:383-388); here HQ is just a flag.
    """

    model_type: str = "vit_h"          # vit_b | vit_l | vit_h
    hq: bool = False                   # SAM-HQ decoder variant
    image_size: int = 1024
    patch_size: int = 16
    prompt_embed_dim: int = 256
    # Per-variant encoder dims; chosen by model_type.
    vit_dims: Tuple[Tuple[str, int, int, int, Tuple[int, ...]], ...] = (
        # (name, embed_dim, depth, num_heads, global_attn_indexes)
        ("vit_b", 768, 12, 12, (2, 5, 8, 11)),
        ("vit_l", 1024, 24, 16, (5, 11, 17, 23)),
        ("vit_h", 1280, 32, 16, (7, 15, 23, 31)),
    )
    window_size: int = 14
    use_flash_attention: bool = True   # Pallas flash kernel for global blocks
    # Windowed-attention implementation:
    #   "xla"            batched einsum + broadcast bias add, fp32 scores
    #   "xla_fused_bias" bias folded into the QK matmul via one-hot lanes
    #                    (plain torch in the port; the JAX package's default)
    #   "pallas"         the hand-written whole-window kernel
    #                    (ops/kernels/window_attention.py, counted as B4)
    #   "pallas_mh"      the same kernel, counted as B5 (the two TPU kernels
    #                    differ only in their grid)
    windowed_attention_impl: str = "xla_fused_bias"
    # Rectangular encode (TPU fast path): pad the model input only to the
    # next patch multiple per side instead of the official 1024x1024 square
    # (segment_anything ResizeLongestSide pads to square; consumed at
    # tools/base_segmenter.py:31-40). For DAVIS-480p this encodes 36x64
    # tokens instead of 64x64 — a ~44% FLOP cut in the pipeline's hottest
    # op. Approximate vs the square encode (pad tokens no longer participate
    # in attention; pos/rel-pos tables are cropped to the sub-grid);
    # tests/test_rect_encode.py bounds the mask delta.
    encode_rect: bool = False
    # Fixed-size aspect-DISTORTING encode (opt-in, fastest): resize every
    # frame directly to this (H, W) — e.g. (448, 896) for 480p: a 28x56
    # token grid that window-14 tiles EXACTLY (zero pad windows) with 62%
    # fewer tokens than the official square. Unlike encode_rect (which
    # preserves the official geometry), this stretches the image ~12% for
    # 16:9 content — a speed/quality trade to validate against real
    # checkpoints before production use. Overrides encode_rect when set.
    encode_fixed_hw: Optional[Tuple[int, int]] = None
    # Fixed-size LETTERBOX encode (opt-in fast gear, geometry-true): resize
    # to FIT this (H, W) (aspect preserved, longest-fit), place the content
    # top-left and zero-pad the rest — exactly the official square's
    # resize+pad semantics, just to a custom grid. (448, 896) for 480p =
    # 28x56 tokens that window-14 tiles EXACTLY (zero pad windows) at 0.875x
    # the official internal resolution with ~10.7% pad tokens (vs 44% for
    # the square). Unlike encode_fixed_hw there is NO aspect distortion —
    # the only delta vs encode_rect is internal resolution. Overrides
    # encode_rect; mutually exclusive with encode_fixed_hw.
    encode_letterbox_hw: Optional[Tuple[int, int]] = None
    mask_threshold: float = 0.0
    max_points: int = 16               # static per-object prompt-point budget
    multimask_output: bool = False

    def __post_init__(self) -> None:
        # A typo'd BENCH_WIN_IMPL must fail loudly, not silently select a
        # kernel and corrupt an A/B measurement.
        valid = ("xla", "xla_fused_bias", "pallas", "pallas_mh")
        if self.windowed_attention_impl not in valid:
            raise ValueError(
                f"windowed_attention_impl {self.windowed_attention_impl!r} "
                f"not in {valid}")
        if self.encode_fixed_hw is not None and self.encode_letterbox_hw is not None:
            raise ValueError(
                "encode_fixed_hw and encode_letterbox_hw are mutually "
                "exclusive — pick the distorting or the letterbox fast gear")
        for name in ("encode_fixed_hw", "encode_letterbox_hw"):
            hw = getattr(self, name)
            if hw is not None and any(v % self.patch_size for v in hw):
                raise ValueError(
                    f"{name}={hw} must be multiples of patch_size "
                    f"({self.patch_size})")

    def encoder_dims(self) -> Tuple[int, int, int, Tuple[int, ...]]:
        for name, d, depth, heads, glb in self.vit_dims:
            if name == self.model_type:
                return d, depth, heads, glb
        raise ValueError(f"unknown SAM model_type {self.model_type!r}")


@dataclasses.dataclass(frozen=True)
class RefinementConfig:
    """Vanishing-mask refinement loop (tracker/base_tracker.py:683-976)."""

    use_refinement: bool = True
    mode: str = "both_neg"             # best config per the paper
    point_algorithm: str = "C"         # C | CP | CPS
    optimized: bool = True             # score-gate reverts to XMem mask
    score_gate: float = 0.94           # base_tracker.py:954
    min_region_area: float = 100.0     # contour area cutoff (base_tracker.py:334)
    max_points: int = 16               # static point budget per object
    max_neg_points: int = 16
    contour_points: int = 5            # ~5 strided contour points (C algo)
    polyline_points: int = 12          # CP budget
    skeleton_points: int = 16          # CPS budget
    dedup_radius: float = 5.0          # DBSCAN eps analogue (base_tracker.py:472)

    def __post_init__(self) -> None:
        if self.mode not in REFINEMENT_MODES:
            raise ValueError(f"refinement mode {self.mode!r} not in {REFINEMENT_MODES}")
        if self.point_algorithm not in POINT_ALGORITHMS:
            raise ValueError(
                f"point algorithm {self.point_algorithm!r} not in {POINT_ALGORITHMS}"
            )


@dataclasses.dataclass(frozen=True)
class InpainterConfig:
    """E2FGVI inpainting knobs (inpainter/config/config.yaml:1-7).

    hq selects the generator variant: True = E2FGVI-HQ (resolution-
    agnostic, SoftComp bias conv — the only variant the reference ever
    instantiates, base_inpainter.py:20); False = the original E2FGVI
    (inpainter/model/e2fgvi.py:133-209 — dead code in the reference):
    identical math except SoftComp carries a learned additive bias pinned
    to the fixed (60, 108) feature grid, so it only supports 240x432
    inputs.

    `hidden_dim`, `num_heads`, `window_size` and `focal_level` state the
    E2FGVI-HQ checkpoint's widths; the generator checks them and builds
    no others. `num_blocks` is the number of focal blocks it builds and
    runs (8 in the checkpoint)."""

    hq: bool = True
    neighbor_stride: int = 5
    num_ref: int = -1
    step: int = 10
    num_subset_frames: int = 50
    num_external_ref: int = 2
    dilate_radius: int = 15            # base_inpainter.py:74-75
    # Static-shape windows: every window carries exactly
    # min(t, 2*stride+1) neighbors (edge windows clamped inward: extra real
    # context frames, not pads) and a fixed ref count padded with frames
    # that every attention softmax masks out, so all windows of a subset
    # have one shape (the reference's variable windows,
    # base_inpainter.py:123-128, have 5-8 per subset). Interior windows
    # equal the variable path; edge windows see more context. Falls back to
    # variable windows for clips of at most 2*stride+1 frames.
    static_windows: bool = True
    # >1: this many static windows go through one batched generator call.
    # Windows of a subset are independent until compositing (read-only on
    # the padded video), so batching multiplies every step of the
    # sequential propagation chain by B: the same depth, B-times larger
    # convolutions and samplings, B-times fewer launches. Requires
    # static_windows; ignored otherwise.
    window_batch: int = 1
    # On-device compositing (default on): the padded video uploads once,
    # windows are gathered on the device, and the reference's
    # masked-composite + 50/50 overlap blend (base_inpainter.py:129-146)
    # runs against a device-resident buffer: one uint8 download per subset
    # instead of an fp32 window download per window. Blend order and
    # arithmetic match the host path. False = the host-compositing
    # reference-shaped path.
    device_composite: bool = True
    # The checkpoint's widths, stated, not chosen: `InpaintGenerator` builds
    # hidden 512, 4 heads, (5, 9) windows and focal level 2, and refuses a
    # config that states others (`generator.check_widths`).
    hidden_dim: int = 512
    num_blocks: int = 8
    num_heads: int = 4
    window_size: Tuple[int, int] = (5, 9)
    focal_level: int = 2


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout for sequence-data-parallel evaluation (§2.14)."""

    data_axis: str = "data"            # whole videos sharded over this axis
    model_axis: str = "model"          # optional TP axis for SAM ViT-H
    data_parallel: int = -1            # -1: all devices
    model_parallel: int = 1
    # Memory-axis sharding for the XMem read (parallel/memory_shard.py):
    # 0/1 = off (single-device read); n>1 shards the LT+work memory tokens
    # over the first n devices and reads via gather-exact-top-k + psum
    # (EXACT — equivalence-tested in tests/test_parallel.py). For memories
    # beyond one chip's HBM or latency-critical very-long rollouts.
    memory_axis_shards: int = 0
    memory_axis: str = "mem"


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    """Root config."""

    xmem: XMemConfig = XMemConfig()
    memory: MemoryConfig = MemoryConfig()
    sam: SAMConfig = SAMConfig()
    refinement: RefinementConfig = RefinementConfig()
    inpainter: InpainterConfig = InpainterConfig()
    parallel: ParallelConfig = ParallelConfig()
    dtype: str = "bfloat16"            # compute dtype on the MXU
    param_dtype: str = "float32"       # master parameter dtype


def small_test_config() -> FrameworkConfig:
    """A tiny config for CPU tests: vit_b-sized SAM, small memory, 3 objects."""
    return FrameworkConfig(
        xmem=XMemConfig(max_objects=3),
        memory=MemoryConfig(max_mid_term_frames=3, min_mid_term_frames=2,
                            max_long_term_elements=256, num_prototypes=16,
                            top_k=8, mem_every=2),
        sam=SAMConfig(model_type="vit_b", image_size=256, max_points=8),
        refinement=RefinementConfig(max_points=8, max_neg_points=8),
        dtype="float32",
    )
