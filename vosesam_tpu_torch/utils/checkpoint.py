"""XMem, SAM and E2FGVI weights into the port (counterpart of
`vosesam_tpu/utils/checkpoint.py`).

The port's `XMem`, `Sam` and `InpaintGenerator` modules use the official
state-dict names (XMem-s012; segment_anything / sam_hq; E2FGVI-HQ), so
  - `load_xmem_checkpoint` reads an official `.pth` straight in, with the
    same dim inference (network.py:134-182) and 4 -> 5 input-channel surgery
    of the value encoder (network.py:184-198) as the JAX loader;
  - `load_sam_checkpoint` reads an official `sam_vit_*` / `sam_hq_vit_h`
    `.pth` (the `image_encoder.` / `prompt_encoder.` / `mask_decoder.` keys);
  - `load_e2fgvi_checkpoint` reads an official `E2FGVI-HQ-CVPR22.pth` or
    `E2FGVI-CVPR22.pth` (under its `netG` key when it has one; SPyNet's
    `mean` / `std` buffers, constants in the port, are dropped);
  - `params_from_jax` turns a JAX parameter tree (nested dicts of numpy
    arrays: the XMem tree, the E2FGVI generator or discriminator tree, or
    `SamParams`) into the same state dict: conv
    HWIO -> OIHW, conv3d THWIO -> OIDHW (a spectral-norm layer's weight,
    `u` and `v` under the reference's `weight_orig`, `weight_u`,
    `weight_v`), conv-transpose HWIO -> IOHW, linear (in, out) -> (out, in),
    embedding tables and other leaves as they are, the non-HQ E2FGVI
    `sc.bias` (H, W, C) -> the official (C, H, W), `key_encoder.layer1.` ->
    the official `key_encoder.res2.`, and `num_batches_tracked` beside every
    batch norm.
All results load with `load_state_dict(strict=True)`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from vosesam_tpu_torch.config import XMemConfig

_KEY_STAGE_RENAME = ("key_encoder.layer1.", "key_encoder.res2.")
# 2-D `.weight` leaves that are embedding tables, not linear layers
_EMBEDDING_MARKERS = ("point_embeddings", "not_a_point_embed", "no_mask_embed",
                      "iou_token", "mask_tokens", "hf_token")
# ConvTranspose2d weights of the SAM (HQ) mask decoder
_CONV_TRANSPOSE = tuple(f"mask_decoder.{m}.{i}.weight"
                        for m in ("output_upscaling", "compress_vit_feat",
                                  "embedding_encoder") for i in (0, 3))
_SAM_PARTS = ("image_encoder", "prompt_encoder", "mask_decoder")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        p = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, p))
        else:
            out[p] = np.asarray(v)
    return out


def params_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """JAX XMem or E2FGVI parameter tree, or `SamParams` (numpy leaves) ->
    the port's state dict."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):     # SamParams
        tree = dict(zip(_SAM_PARTS, tree))
    sd: Dict[str, torch.Tensor] = {}
    flat = _flatten(tree)
    # spectral-norm layers (the discriminator's): weight, u, v
    sn_layers = {k[:-2] for k in flat if k.endswith(".u") and k[:-2] + ".v" in flat}
    for key, arr in flat.items():
        if key.startswith(_KEY_STAGE_RENAME[0]):
            key = _KEY_STAGE_RENAME[1] + key[len(_KEY_STAGE_RENAME[0]):]
        arr = np.array(arr, np.float32)
        layer, _, leaf = key.rpartition(".")
        if layer in sn_layers:
            key = f"{layer}.weight_{'orig' if leaf == 'weight' else leaf}"
        if key.endswith(("weight", "weight_orig")) and arr.ndim == 5:   # THWIO -> OIDHW
            arr = np.transpose(arr, (4, 3, 0, 1, 2))
        elif key in _CONV_TRANSPOSE:                       # HWIO -> IOHW
            arr = np.transpose(arr, (2, 3, 0, 1))
        elif key == "sc.bias":                             # HWC -> CHW
            arr = np.transpose(arr, (2, 0, 1))
        elif key.endswith(".weight") and arr.ndim == 4:    # HWIO -> OIHW
            arr = np.transpose(arr, (3, 2, 0, 1))
        elif (key.endswith(".weight") and arr.ndim == 2
              and not any(m in key for m in _EMBEDDING_MARKERS)):   # (in, out) -> (out, in)
            arr = arr.T
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
        if key.endswith(".running_var"):
            sd[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def infer_xmem_dims(state_dict: Mapping[str, Any]) -> Tuple[int, int, int]:
    """(key_dim, value_dim, hidden_dim) from weight shapes (network.py:134-182)."""
    key_dim = tuple(state_dict["key_proj.key_proj.weight"].shape)[0]
    value_dim = tuple(state_dict["value_encoder.fuser.block2.conv2.weight"].shape)[0]
    if "decoder.hidden_update.transform.weight" in state_dict:
        hidden_dim = tuple(state_dict["decoder.hidden_update.transform.weight"].shape)[0] // 3
    else:
        hidden_dim = 0
    return key_dim, value_dim, hidden_dim


def xmem_state_dict(
    sd: Mapping[str, Any],
    cfg: Optional[XMemConfig] = None,
) -> Tuple[Dict[str, torch.Tensor], XMemConfig]:
    """An official-schema XMem state dict -> (state dict for `XMem`, cfg with
    the inferred dims; `max_objects` / `single_object` kept from `cfg`). A
    4-channel (single-object) value encoder gets a zero 5th input channel."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    key_dim, value_dim, hidden_dim = infer_xmem_dims(sd)
    base = cfg or XMemConfig()
    cfg = XMemConfig(key_dim=key_dim, value_dim=value_dim, hidden_dim=hidden_dim,
                     max_objects=base.max_objects, single_object=base.single_object)

    w = sd["value_encoder.conv1.weight"]            # (64, 4 or 5, 7, 7)
    in_ch = w.shape[1]
    want = 4 if cfg.single_object else 5
    if in_ch != want:
        if in_ch == 4 and want == 5:
            pad = torch.zeros((w.shape[0], 1, *w.shape[2:]), dtype=w.dtype)
            sd["value_encoder.conv1.weight"] = torch.cat([w, pad], dim=1)
        elif in_ch == 5 and want == 4:
            sd["value_encoder.conv1.weight"] = w[:, :4]
        else:
            raise ValueError(f"unexpected value_encoder.conv1 input channels {in_ch}")

    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        out[k] = v if k.endswith("num_batches_tracked") else v.float()
        if k.endswith(".running_var"):
            out.setdefault(k[: -len("running_var")] + "num_batches_tracked", torch.tensor(0))
    return out, cfg


def load_xmem_checkpoint(
    path: str,
    cfg: Optional[XMemConfig] = None,
) -> Tuple[Dict[str, torch.Tensor], XMemConfig]:
    """Read XMem-s012.pth (or a trainer checkpoint holding it under
    "network") into (state dict for `XMem`, inferred cfg)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "network" in sd and isinstance(sd["network"], dict):
        sd = sd["network"]
    return xmem_state_dict(sd, cfg)


def load_sam_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read an official sam_vit_{b,l,h} / sam_hq_vit_h `.pth` into a state
    dict for `Sam` (fp32; keys outside the three sub-modules dropped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: torch.as_tensor(v).float() for k, v in sd.items()
            if k.split(".", 1)[0] in _SAM_PARTS}


def load_e2fgvi_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read an E2FGVI generator `.pth` (inpainter/base_inpainter.py:23 loads
    it straight into InpaintGenerator) into a state dict for
    `InpaintGenerator` (fp32). Both variants load: the HQ file carries
    `sc.bias_conv.*`, the original E2FGVI file the learned (C, 60, 108)
    `sc.bias`; build the module with the matching `InpainterConfig.hq`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "netG" in sd:
        sd = sd["netG"]
    return {k: torch.as_tensor(v).float() for k, v in sd.items()
            if k not in ("update_spynet.mean", "update_spynet.std")}
