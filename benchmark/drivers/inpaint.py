"""Whole videos through the facade's inpainter, as the app's inpaint button
runs it (`AppSession.inpaint`): `system.model.baseinpainter.inpaint(frames,
masks, ratio)`, one whole video a call, back to back, closed loop, through
the traffic's videos in their order from a video drawn from the seed (a
window reaches about a third of them). A call ends when every inpainted
frame is on the host as uint8.

The inpainter is the port's `Inpainter` over its `InpaintGenerator`, built
on the meta device and given the benchmark's weights with
`load_state_dict(strict=True, assign=True)` (every parameter's shape held
to the plain reference's), and handed to the facade as the app hands it a
checkpoint's. The configuration's stated widths go into the port's
`InpainterConfig`, which the generator refuses unless they are the
checkpoint's.

The check (`judge`), on each sampled call:
  - two windows, captured as the program ran them (its first: an edge
    window with a padded reference slot; the middle one of its first
    subset): the gathered input, `num_local`, `frame_valid`, the flows, the
    encoder's and the propagation's outputs, the transformer's (the soft
    composite's) output and the prediction. The plain reference
    (`plainref.models.e2fgvi`, float32, TF32 off) runs each stage on the
    program's own inputs of that stage, and the whole window on the
    program's input; relative errors over the valid frames, and for the
    flows, the decoder and the whole window also the largest difference in
    pixels of flow (`e2fgvi_flow_max_px`) or in grey levels of the
    [0, 255] frames (`..._max_gl`). The limits hold those three: random
    weights give flows of 0.2-1 pixel RMS and predictions of 0.02-0.04 RMS
    by seed, so a relative error there varies with the seed's output size
    (the float32 program's and the control's overlap over 14 seeds for the
    flows), while the error in pixels or grey levels, which is what a warp
    or a viewer sees, does not;
  - the composite, exactly: outside the dilated mask every output pixel is
    the input's (`composite_outside_gap`); and on the first sampled call
    the delivered frames against the composite rebuilt from every window's
    prediction by the published rule (each window writes its anchor's
    neighbour frames, a frame written twice takes the mean of the two),
    in grey levels (`composite_inside_gap`);
  - kernel B6's plain fallbacks in the window (`deform_plain_calls`) and
    the precision flags that the configuration states.
The control is the reference with every product's operands rounded to
bfloat16 (TF32 off): the step below this configuration's float32. It
takes the place of the float8 control that `control.py` passes."""

from __future__ import annotations

import contextlib
import math
import sys
import traceback
from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from harness import compare, precision, seeds, weights
from harness.patching import wrapped
from traffic import frames as FR
from traffic import generate

P = "vosesam_tpu_torch.models.e2fgvi."
Q = "vosesam_tpu_torch.pipeline.inpaint:Inpainter."
_SALT = 13          # the inpainter's weights (XMem's and SAM's take 11 and 12)
_START_SALT = 26    # the video the cycle starts from
INPAINTER_KEYS = ("hq", "neighbor_stride", "num_ref", "step", "num_subset_frames",
                  "num_external_ref", "dilate_radius", "static_windows", "window_batch",
                  "device_composite", "hidden_dim", "num_blocks", "num_heads", "window_size",
                  "focal_level")
STAGES = ("flow", "encode", "propagate", "transformer", "decode", "window")
NUMBERS = tuple(f"e2fgvi_{s}_relerr" for s in STAGES) + (
    "e2fgvi_flow_max_px", "e2fgvi_flow_rms_px", "e2fgvi_decode_max_gl", "e2fgvi_window_max_gl",
    "composite_outside_gap", "composite_inside_gap", "deform_plain_calls",
    "precision_flags_mismatch")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def object_masks(n: int, h: int, w: int, o: int) -> np.ndarray:
    """(n, H, W) bool: in frame i the union of the o objects' 120x160
    rectangles where `multi_object_frames` paints them."""
    m = np.zeros((n, h, w), bool)
    for i in range(n):
        for k in range(o):
            yb, xb = FR.anchor(k)
            y0 = yb + FR.tri((2 + k % 3) * i, 60)
            x0 = xb + FR.tri((3 + k % 2) * i, 40)
            m[i, y0:y0 + 120, x0:x0 + 160] = True
    return m


def inpainter_config(section: Dict):
    """The port's InpainterConfig as the configuration states it."""
    from vosesam_tpu_torch.config import InpainterConfig

    kw = {k: section[k] for k in INPAINTER_KEYS if k in section}
    kw["window_size"] = tuple(kw["window_size"])
    return InpainterConfig(**kw)


def reference_module(section: Dict):
    """The plain reference's generator for the section, on the meta device."""
    from plainref.models.e2fgvi import generator as R

    with torch.device("meta"):
        return R.InpaintGenerator(R.E2FGVIConfig.from_section(section))


class Bfloat16Products(TorchFunctionMode):
    """The control: every product's operands rounded to bfloat16, the
    products accumulated in float32: (input, weight) of a linear layer or
    convolution, every operand of a matmul or einsum."""

    @staticmethod
    def _bf16(x):
        if not isinstance(x, torch.Tensor) or not x.is_floating_point():
            return x
        return x.to(torch.bfloat16).to(x.dtype)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        r = self._bf16
        if func in precision._TWO_OPERANDS:
            args = (r(args[0]), r(args[1])) + tuple(args[2:])
        elif func in precision._ALL_OPERANDS:
            args = tuple([r(t) for t in a] if isinstance(a, (list, tuple)) else r(a)
                         for a in args)
        return func(*args, **kwargs)


def _rms(t: torch.Tensor) -> float:
    return float(t.double().pow(2).mean().sqrt())


class Call(NamedTuple):
    video: int
    units: int       # the video's frames


def window_shapes(n: int, icfg) -> set:
    """The (slots, local frames) of every window of an n-frame video under
    static windows: each subset's one shape."""
    from vosesam_tpu_torch.pipeline import inpaint as I

    s, step = icfg.neighbor_stride, icfg.step
    if n <= icfg.num_subset_frames:
        lengths = [n]
    else:
        lengths = [len(pre) + b - a + len(post) for a, b, pre, post in I.subset_splits(n, icfg)]
    return {(min(t, 2 * s + 1) + I.static_ref_budget(t, s, step), min(t, 2 * s + 1))
            for t in lengths}


class Driver:
    unit = "frames"

    def __init__(self, system, spec, seed: int) -> None:
        from vosesam_tpu_torch.models.e2fgvi import generator as G
        from vosesam_tpu_torch.pipeline.inpaint import Inpainter

        self.system, self.spec, self.seed = system, spec, seed
        self.section = system.cfg["e2fgvi"]
        self.ratio = float(self.section["ratio"])
        self.icfg = inpainter_config(self.section)
        if not self.icfg.static_windows or self.icfg.num_ref != -1:
            raise ValueError("the inpaint driver warms up static windows only")
        dev = system.device
        self.weights = weights.make(reference_module(self.section), seeds.derive(seed, _SALT),
                                    dev, torch.float32)
        with torch.device("meta"):
            net = G.InpaintGenerator(self.icfg)
        net.load_state_dict(self.weights, strict=True, assign=True)
        system.model.baseinpainter = Inpainter(cfg=self.icfg, net=net, device=dev)
        self.videos = generate.videos(spec, seed)
        h, w = spec["height"], spec["width"]
        shortest = 2 * self.icfg.neighbor_stride + 1
        if any(len(v["frames"]) <= shortest for v in self.videos):
            raise ValueError(f"every video needs more than {shortest} frames (static windows)")
        self.masks = [object_masks(len(v["frames"]), h, w, v["objects"]) for v in self.videos]
        self.cycle = [Call(i, len(v["frames"])) for i, v in enumerate(self.videos)]
        self.start = int(seeds.rng(seed, _START_SALT).integers(len(self.cycle)))
        self._plain0 = self._b6 = None
        self.flags = None
        self._composite_taken = False

    @property
    def inpainter(self):
        return self.system.model.baseinpainter

    def call(self, i: int) -> Call:
        return self.cycle[(self.start + i) % len(self.cycle)]

    def _run(self, c: Call) -> List[np.ndarray]:
        return self.inpainter.inpaint(self.videos[c.video]["frames"], self.masks[c.video],
                                      self.ratio)

    def run(self, c: Call) -> None:
        self._run(c)

    def _capture_calls(self, n: int) -> set:
        """Generator calls to capture in an n-frame video: its first and the
        middle one of its first subset."""
        from vosesam_tpu_torch.pipeline import inpaint as I

        t0 = n
        if n > self.icfg.num_subset_frames:
            a, b, pre, post = I.subset_splits(n, self.icfg)[0]
            t0 = len(pre) + b - a + len(post)
        windows = -(-t0 // self.icfg.neighbor_stride)
        calls = -(-windows // max(1, self.icfg.window_batch))
        return {0, calls // 2}

    def run_captured(self, c: Call) -> Dict:
        """The call with the generator's stages captured in the chosen
        windows: {video, windows: [{in, num_local, valid, flows, encode,
        propagate, trans, pred}], out: the call's frames, subsets}. On the
        first sampled call `subsets` holds, for each subset, what the device
        composite was given (its frames, masks and window plans) and every
        window's prediction; else None."""
        cap: Dict = {"video": c.video, "windows": [], "subsets": None}
        want = self._capture_calls(c.units)
        st = {"i": -1, "rec": None}

        def gen(fn):
            def w(*a, **k):
                st["i"] += 1
                if st["i"] not in want:
                    return fn(*a, **k)
                valid = k.get("frame_valid", a[4] if len(a) > 4 else None)
                rec = {"in": a[1], "num_local": int(a[2]), "valid": valid}
                st["rec"] = rec
                try:
                    out = fn(*a, **k)
                finally:
                    st["rec"] = None
                rec["pred"], rec["flows"] = out[0], out[1]
                cap["windows"].append(rec)
                return out
            return w

        def stage(key):
            def make(fn):
                def w(*a, **k):
                    out = fn(*a, **k)
                    if st["rec"] is not None:
                        st["rec"][key] = out
                    return out
                return w
            return make

        def composite(fn):
            def w(inp, groups, frames_f, masks_f, *a):
                cap["subsets"].append({"plans": [p for g in groups for p in g],
                                       "frames": frames_f, "masks": masks_f, "preds": []})
                return fn(inp, groups, frames_f, masks_f, *a)
            return w

        def predict(fn):
            def w(inp, padded, plans):
                out = fn(inp, padded, plans)
                cap["subsets"][-1]["preds"].extend(out)
                return out
            return w

        items = [(P + "generator:generator_forward", gen),
                 (P + "generator:encoder_forward", stage("encode")),
                 (P + "generator:bidirectional_propagation", stage("propagate")),
                 (P + "modules:soft_comp", stage("trans"))]
        if not self._composite_taken:
            self._composite_taken = True
            cap["subsets"] = []
            items += [(Q + "_composite_device", composite), (Q + "_predict", predict)]
        with wrapped(items):
            cap["out"] = self._run(c)
        return cap

    def warm_up(self) -> None:
        """Every window shape the traffic uses, one generator call each at
        the padded frame size, then the shortest video through the whole
        path."""
        from vosesam_tpu_torch.models.e2fgvi import generator as G
        from vosesam_tpu_torch.pipeline.inpaint import MOD_H, MOD_W

        h, w = self.spec["height"], self.spec["width"]
        ph, pw = h + (-h % MOD_H), w + (-w % MOD_W)
        shapes = sorted(set().union(*(window_shapes(c.units, self.icfg) for c in self.cycle)))
        dev = self.system.device
        with torch.no_grad():
            for t, lt in shapes:
                x = torch.zeros((1, t, ph, pw, 3), device=dev)
                valid = torch.ones((1, t), dtype=torch.bool, device=dev)
                G.generator_forward(self.inpainter.net, x, lt, self.icfg, frame_valid=valid)
        self._run(min(self.cycle, key=lambda c: c.units))

    def plan(self) -> List[int]:
        """Sampled calls among the `within` that follow the traced stretch.
        Also the start of the window for B6's counters and the precision
        flags in force."""
        from vosesam_tpu_torch.ops.kernels import deform_align

        self._plain0 = dict(deform_align.COUNTS)
        self.flags = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                      "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
        chk = self.spec["check"]
        r = seeds.rng(self.seed, 25)
        idx = list(range(self.trace_calls(), self.trace_calls() + chk["within"]))
        return sorted(int(i) for i in r.choice(idx, chk["calls"], replace=False))

    def trace_calls(self) -> int:
        return self.spec["trace"]["calls"]

    def release(self) -> None:
        """The window's B6 counters read; the program's inpainter dropped."""
        from vosesam_tpu_torch.ops.kernels import deform_align

        now = dict(deform_align.COUNTS)
        self._b6 = {k: now[k] - self._plain0.get(k, 0) for k in now}
        log(f"# B6 in the window (launches; plain calls): {self._b6}")
        self.system.model.baseinpainter = None

    # ---------------------------------------------------------------- check

    def _reference(self, device: torch.device):
        net = reference_module(self.section)
        net.load_state_dict(self.weights, strict=True, assign=True)
        return net.eval()

    def judge(self, caps, ref, control=None):
        """Worst numbers over the sampled calls; with `control` (control.py's
        float8 reference, whose place the bfloat16 control takes) the
        control's too, as a second dict."""
        dev = ref.device
        net = self._reference(dev)
        prog: Dict[str, float] = {}
        ctrl: Dict[str, float] = {}
        for cap in caps:
            try:
                p, c = self._judge_call(cap, net, dev, control is not None)
            except (RuntimeError, ValueError, IndexError, KeyError, TypeError):
                traceback.print_exc()
                p = c = dict.fromkeys(NUMBERS[:-2], math.inf)
            for out, d in ((prog, p), (ctrl, c)):
                for k, v in d.items():
                    out[k] = max(out.get(k, 0.0), v)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        plain = float(self._b6.get("plain", 0)) if dev.type == "cuda" else 0.0
        prog["deform_plain_calls"] = plain
        want = self.system.cfg["precision"]
        prog["precision_flags_mismatch"] = float(any(
            self.flags[k] != want[k] for k in ("cudnn_allow_tf32", "matmul_allow_tf32")))
        # the first sampled call rebuilds the composite; none that did reads inf
        prog.setdefault("composite_inside_gap", math.inf)
        ctrl.update(deform_plain_calls=0.0, precision_flags_mismatch=0.0,
                    composite_outside_gap=0.0, composite_inside_gap=0.0)
        return prog if control is None else (prog, ctrl)

    def _judge_call(self, cap, net, dev, with_control: bool):
        prog: Dict[str, float] = {}
        ctrl: Dict[str, float] = {}
        if len(cap["windows"]) != 2:
            raise ValueError(f"{len(cap['windows'])} windows captured, 2 expected")
        for rec in cap["windows"]:
            p, c, inside = self._judge_window(rec, net, dev, with_control)
            log(f"# video {cap['video']} window T {rec['in'].shape[-4]}: program {p}; "
                f"deformable samples inside the field {inside:.4f}")
            for out, d in ((prog, p), (ctrl, c)):
                for k, v in d.items():
                    out[k] = max(out.get(k, 0.0), v)
        prog["composite_outside_gap"] = self._composite_gap(cap, dev)
        if cap["subsets"] is not None:
            prog["composite_inside_gap"] = self._composite_inside_gap(cap, dev)
        return prog, ctrl

    def _composite_inside_gap(self, cap, dev) -> float:
        """Largest |delivered - rebuilt| in grey levels over the call's
        frames. The rebuilt video: in each subset, window k (anchor 5k)
        writes the neighbour frames of its anchor from its prediction's slot
        of that frame (cropped to the frame, mapped to [0, 255], composited
        with the frame by the mask), a frame written again takes the mean of
        the two, then clamped and cast to uint8; the subsets cut and joined
        as the video's subset plan says. inf when the capture does not cover
        the call."""
        from vosesam_tpu_torch.pipeline import inpaint as I

        s = self.icfg.neighbor_stride
        n = len(cap["out"])
        splits = ([(0, n, [], [])] if n <= self.icfg.num_subset_frames
                  else I.subset_splits(n, self.icfg))
        if len(splits) != len(cap["subsets"]):
            return math.inf
        parts, last = [], []
        for (a, b, pre, _), sub in zip(splits, cap["subsets"]):
            frames, masks = sub["frames"], sub["masks"]
            t, h, w = frames.shape[:3]
            anchors = range(0, t, s)
            if len(sub["plans"]) != len(anchors) or len(sub["preds"]) != len(anchors):
                return math.inf
            comp: List = [None] * t
            only: List = [None] * t
            for f, (ids, lt, _, _), pred in zip(anchors, sub["plans"], sub["preds"]):
                local = [int(i) for i in ids[:lt]]
                for j in range(max(0, f - s), min(t, f + s + 1)):
                    seg = (pred[local.index(j), :h, :w] + 1.0) / 2.0 * 255.0
                    m = masks[j, ..., None]
                    img = seg * m + frames[j] * (1.0 - m)
                    comp[j] = img if comp[j] is None else 0.5 * comp[j] + 0.5 * img
                    only[j] = img
            cut = slice(len(pre), len(pre) + b - a)
            parts.append(torch.stack(comp[cut]).clamp(0, 255).to(torch.uint8))
            last.append(torch.stack(only[cut]).clamp(0, 255).to(torch.uint8))
        out = torch.from_numpy(np.stack([np.asarray(f) for f in cap["out"]])).to(dev)
        video, keep_last = torch.cat(parts).to(dev), torch.cat(last).to(dev)
        if out.shape != video.shape:
            return math.inf
        log(f"# video {cap['video']}: a composite that kept each frame's last window "
            f"would read {int((keep_last.int() - video.int()).abs().max())} grey levels "
            f"from the rebuilt one")
        return float((out.int() - video.int()).abs().max())

    def _composite_gap(self, cap, dev) -> float:
        """Largest |output - input| outside the dilated mask (inf when the
        output is not the video's frames as uint8)."""
        frames = self.videos[cap["video"]]["frames"]
        out = np.stack([np.asarray(f) for f in cap["out"]])
        if out.shape != frames.shape or out.dtype != np.uint8:
            return math.inf
        r = int(self.section["dilate_radius"])
        m = torch.from_numpy(self.masks[cap["video"]]).to(dev).float()[:, None]
        dil = F.max_pool2d(m, 2 * r + 1, stride=1, padding=r)[:, 0] > 0
        diff = (torch.from_numpy(out).to(dev).int() - torch.from_numpy(frames).to(dev).int()).abs()
        outside = diff.amax(-1)[~dil]
        return float(outside.max()) if outside.numel() else 0.0

    @torch.no_grad()
    def _judge_window(self, rec, net, dev, with_control: bool):
        """Program and control against the float32 reference, stage by stage
        on the program's own inputs, and the whole window."""
        from plainref.models.e2fgvi import generator as R

        def nchw(t, b, n):       # (..., H, W, C) program tensor -> (B, n, C, H, W)
            return t.float().reshape(b, n, *t.shape[-3:]).permute(0, 1, 4, 2, 3)

        x = rec["in"].float()
        if x.ndim == 4:
            x = x[None]
        b, t = x.shape[:2]
        lt = rec["num_local"]
        valid = rec["valid"]
        if valid is not None:
            valid = valid.reshape(b, t).to(dev)
        sel = valid if valid is not None else torch.ones((b, t), dtype=torch.bool, device=dev)
        xin = x.permute(0, 1, 4, 2, 3)
        pf, pb = (nchw(f, b, lt - 1) for f in rec["flows"])
        pe = nchw(rec["encode"], b, t)
        pp = nchw(rec["propagate"], b, lt)
        pt = nchw(rec["trans"], b, t)
        pd = nchw(rec["pred"], b, t)
        feat = torch.cat([pp, pe[:, lt:]], 1)

        def run(mode: str):
            """Each stage on the program's inputs, then the whole window as the
            reference's own chain: {stage: output}, the in-field share."""
            products = Bfloat16Products() if mode == "bf16" else contextlib.nullcontext()
            with precision.mode("fp32"), products:
                o = {}
                o["flow"] = R.flows(net, (xin[:, :lt] + 1) / 2)
                o["encode"] = R.encode(net, xin)
                o["propagate"] = R.propagate(net, pe[:, :lt], pf, pb)
                o["transformer"] = R.transform(net, feat, valid)
                o["decode"] = R.decode(net, feat + pt)
                record: list = []
                own = R.propagate(net, o["encode"][:, :lt], *o["flow"], record=record)
                own = torch.cat([own, o["encode"][:, lt:]], 1)
                o["window"] = R.decode(net, own + R.transform(net, own, valid))
            inside = sum(a for a, _ in record) / max(1, sum(n for _, n in record))
            return o, inside

        def gaps(side, ref):
            s = {"flow": max(compare.relerr(side["flow"][0], ref["flow"][0]),
                             compare.relerr(side["flow"][1], ref["flow"][1])),
                 "flow_max_px": max(compare.maxgap(side["flow"][0], ref["flow"][0]),
                                    compare.maxgap(side["flow"][1], ref["flow"][1])),
                 "flow_rms_px": max(_rms(side["flow"][0] - ref["flow"][0]),
                                    _rms(side["flow"][1] - ref["flow"][1])),
                 "encode": compare.relerr(side["encode"], ref["encode"]),
                 "propagate": compare.relerr(side["propagate"], ref["propagate"])}
            for k in ("transformer", "decode", "window"):
                s[k] = compare.relerr(side[k][sel], ref[k][sel])
            for k in ("decode", "window"):      # in grey levels of the [0, 255] frames
                s[k + "_max_gl"] = 127.5 * compare.maxgap(side[k][sel], ref[k][sel])
            return {f"e2fgvi_{k}" if k.endswith(("px", "gl")) else f"e2fgvi_{k}_relerr": v
                    for k, v in s.items()}

        ref, inside = run("fp32")
        mine = {"flow": (pf, pb), "encode": pe, "propagate": pp, "transformer": pt,
                "decode": pd, "window": pd}
        p = gaps(mine, ref)
        c = gaps(run("bf16")[0], ref) if with_control else {}
        return p, c, inside

