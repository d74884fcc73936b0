"""What the timed path produces on the calls that the check samples, read
through hooks from the benchmark's files: the tracker state before and
after the call (cloned, since the port updates it in place), each stage of
each XMem step with its inputs, the memory writes, the SAM encodes, the
refinement's inputs and SAM's decodes before the score gate. The hooks are
installed for a sampled call only."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List

import torch

from harness.patching import wrapped

P = "vosesam_tpu_torch."


def clone_state(obj: Any) -> Any:
    """A deep copy of a dataclass tree of tensors and numbers."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: clone_state(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    return obj


@contextlib.contextmanager
def module_outputs(modules: Dict[str, torch.nn.Module], rec: Dict[str, List]):
    """Records each named module's output (and, for the value encoder's
    fuser, its inputs) into `rec[name]` while open."""
    handles = []
    for name, mod in modules.items():
        rec.setdefault(name, [])
        handles.append(mod.register_forward_hook(
            lambda m, inp, out, name=name: rec[name].append({"in": inp, "out": out})))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def xmem_modules(net) -> Dict[str, torch.nn.Module]:
    """The XMem submodules whose outputs the check reads: the decoder's
    low-resolution mask logits and the value encoder's fusion block."""
    return {"pred": net.decoder.pred, "value_fuser": net.value_encoder.fuser}


def tracking_hooks(rec: Dict[str, List], net=None):
    """A context that records, in call order, each as a dict tagged with the
    step it belongs to (`step`: the index of the XMem step of the call):
      steps    each step's probabilities, (1+O, H, W);
      keys     the key encoder's (key, shrinkage, selection);
      reads    the memory read's (qk, qe) and readout;
      segments the decoder's inputs (feats, readout, hidden, valid, h_out)
               and outputs (hidden, logits, prob);
      values   the value encoder's inputs (f16, hidden, prob, valid, deep)
               and outputs (value, hidden);
      writes   each memory write: the state before (cloned), its inputs
               (key, shrinkage, selection, value, valid, hw) and the state
               after (cloned);
      encodes, refines, decodes: SAM's encodes (ImageEmbedding), the
               refinement's (masks, logits, scores, valid) inputs and its
               decodes' (coords, labels, low_res, iou)."""
    for k in ("steps", "keys", "reads", "segments", "values", "writes", "encodes",
              "refines", "decodes"):
        rec.setdefault(k, [])
    at = lambda: len(rec["steps"])     # noqa: E731  (the step in flight)

    def step(fn):
        def w(*a, **k):
            out = fn(*a, **k)
            rec["steps"].append({"prob": out[1]})
            return out
        return w

    def key(fn):
        def w(*a, **k):
            out = fn(*a, **k)
            rec["keys"].append({"step": at(), "out": out})
            return out
        return w

    def read(fn):
        def w(state, qk, qe, cfg, *a, **k):
            out = fn(state, qk, qe, cfg, *a, **k)
            rec["reads"].append({"step": at(), "qk": qk, "qe": qe, "out": out[0]})
            return out
        return w

    def segment(fn):
        def w(net, feats, readout, hidden, valid, cfg, h_out=True):
            out = fn(net, feats, readout, hidden, valid, cfg, h_out=h_out)
            rec["segments"].append({"step": at(), "in": (feats, readout, hidden, valid, h_out),
                                    "out": out})
            return out
        return w

    def value(fn):
        def w(net, frame, f16, hidden, masks, valid, cfg, is_deep_update=True):
            out = fn(net, frame, f16, hidden, masks, valid, cfg, is_deep_update=is_deep_update)
            rec["values"].append({"step": at(), "in": (f16, hidden, masks, valid, is_deep_update),
                                  "out": out})
            return out
        return w

    def write(fn):
        def w(state, key, shrinkage, selection, value, obj_valid, cfg, hw):
            before = clone_state(state)
            out = fn(state, key, shrinkage, selection, value, obj_valid, cfg, hw)
            rec["writes"].append({"step": at(), "before": before,
                                  "in": (key, shrinkage, selection, value, obj_valid, hw),
                                  "after": clone_state(out)})
            return out
        return w

    def encode(fn):
        def w(*a, **k):
            out = fn(*a, **k)
            rec["encodes"].append(out)
            return out
        return w

    def refine(fn):
        def w(sam, emb, masks, logits, scores, valid, cfg):
            rec["refines"].append((masks, logits, scores, valid))
            return fn(sam, emb, masks, logits, scores, valid, cfg)
        return w

    def decode(fn):
        def w(sam, emb, coords, labels, *a, **k):
            out = fn(sam, emb, coords, labels, *a, **k)
            rec["decodes"].append((coords, labels) + tuple(out))
            return out
        return w

    stack = contextlib.ExitStack()
    stack.enter_context(wrapped([
        (P + "inference.core:step", step),
        (P + "inference.core:step_with_mask", step),
        (P + "models.xmem.network:encode_key", key),
        (P + "memory.manager:match_memory", read),
        (P + "models.xmem.network:segment", segment),
        (P + "models.xmem.network:encode_value", value),
        (P + "memory.manager:add_memory", write),
        (P + "models.sam.predictor:encode_image", encode),
        (P + "inference.chunked:refine_masks", refine),
        (P + "inference.tracker:refine_masks", refine),
        (P + "models.sam.predictor:predict_low_res", decode),
    ]))
    if net is not None:
        stack.enter_context(module_outputs(xmem_modules(net), rec))
    return stack
