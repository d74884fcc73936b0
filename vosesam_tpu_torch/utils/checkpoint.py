"""XMem weights into the port (counterpart of `vosesam_tpu/utils/checkpoint.py`).

The port's `XMem` module uses the official XMem-s012 state-dict names, so
  - `load_xmem_checkpoint` reads an official `.pth` straight in, with the
    same dim inference (network.py:134-182) and 4 -> 5 input-channel surgery
    of the value encoder (network.py:184-198) as the JAX loader;
  - `params_from_jax` turns the JAX package's XMem parameter tree (nested
    dicts of numpy arrays) into the same state dict: conv HWIO -> OIHW,
    linear (in, out) -> (out, in), `key_encoder.layer1.` -> the official
    `key_encoder.res2.`, and `num_batches_tracked` beside every batch norm.
Both results load into `XMem` with `load_state_dict(strict=True)`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from vosesam_tpu_torch.config import XMemConfig

_KEY_STAGE_RENAME = ("key_encoder.layer1.", "key_encoder.res2.")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        p = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, p))
        else:
            out[p] = np.asarray(v)
    return out


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX XMem parameter tree (numpy leaves) -> the port's state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for key, arr in _flatten(tree).items():
        if key.startswith(_KEY_STAGE_RENAME[0]):
            key = _KEY_STAGE_RENAME[1] + key[len(_KEY_STAGE_RENAME[0]):]
        arr = np.array(arr, np.float32)
        if key.endswith(".weight") and arr.ndim == 4:      # HWIO -> OIHW
            arr = np.transpose(arr, (3, 2, 0, 1))
        elif key.endswith(".weight") and arr.ndim == 2:    # (in, out) -> (out, in)
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
