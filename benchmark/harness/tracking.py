"""Shared by the tracking drivers: running a sampled call with its capture,
and judging it against the reference (`reference.Reference`).

Random-weight XMem is chaotic across frames: its readout is close to the
value of the single nearest memory slot, so a rounding that changes which
slot is nearest changes a pixel's readout wholly, and the decoder's gain
carries that into the masks of later frames. So the check does not follow
a call's frames with the reference's own masks; it follows the program step
by step and stage by stage, on the program's own inputs of each stage (the
key encoder on the raw frame; the first read on the program's memory
before the call; the decoder, the value encoder and each memory write on
the program's inputs), checks the schedule's counters after the call, and
checks the call's answer against the one that the program's own parts
make."""

from __future__ import annotations

import math
import traceback
from typing import Dict, List

import numpy as np
import torch

from harness import capture, compare
from traffic import schedule


class Captured:
    """One sampled call: its inputs, the program's state before it, and what
    the timed path produced (the call's masks and the hooks' records)."""

    def __init__(self, frames: np.ndarray, n_obj: int, state):
        self.frames, self.n_obj, self.state = frames, n_obj, state
        self.rec: Dict[str, List] = {}
        self.masks: List[np.ndarray] = []
        self.state_after = None


def run_captured(tracker, frames: np.ndarray, n_obj: int, call, first: bool) -> Captured:
    """Run `call()` (the tracker call, returning its masks) with the hooks
    on, after cloning the tracker's state (none before a video's first
    frame: its call starts from a fresh state)."""
    cap = Captured(frames, n_obj, None if first else capture.clone_state(tracker.state))
    with capture.tracking_hooks(cap.rec, tracker.net):
        cap.masks = call()
    cap.state_after = capture.clone_state(tracker.state)
    return cap


def _groups(n: int, chunk: int) -> List[List[int]]:
    """The frames of a `track_batch` call as it groups them: whole chunks,
    then the remainder one frame at a time."""
    full = (n // chunk) * chunk
    return [list(range(i, i + chunk)) for i in range(0, full, chunk)] + [[i] for i in range(full, n)]


def _rel(pairs) -> float:
    return max((compare.relerr(a, b) for a, b in pairs if a is not None and b.numel()),
               default=0.0)


def memory_gap(a, b):
    """How a memory state lies from the reference's: (1 where the slots in
    use or the valid objects differ, else 0; the worst relative error over
    the working and long-term slots in use)."""
    if (a.work.count != b.work.count or not torch.equal(a.obj_valid.cpu(), b.obj_valid.cpu())
            or not torch.equal(a.long.key_valid.cpu(), b.long.key_valid.cpu())):
        return 1.0, math.inf
    n, lt = a.work.count, b.long.key_valid
    return 0.0, _rel([(a.work.keys[:n], b.work.keys[:n]),
                      (a.work.shrinkage[:n], b.work.shrinkage[:n]),
                      (a.work.values[:, :n], b.work.values[:, :n]),
                      (a.long.keys[lt], b.long.keys[lt]), (a.long.shrinkage[lt], b.long.shrinkage[lt]),
                      (a.long.values[:, lt], b.long.values[:, lt])])


def schedule_gap(cap: Captured, mem: Dict) -> float:
    """1 unless the call ran one XMem step per frame and left the state's
    counters (frame index, last memory frame, working slots in use,
    long-term slots in use) where XMem's schedule puts them, counted from
    the state before the call; else 0."""
    after = cap.state_after
    h, w = cap.frames.shape[1:3]
    hw = schedule.tokens(h, w)
    cw, mw = mem["max_mid_term_frames"] * hw, mem["min_mid_term_frames"] * hw
    lt_cap = mem["max_long_term_elements"]
    p = min(mem["num_prototypes"], cw - mw)
    if cap.state is None:
        ti, last, count, lt = -1, 0, 0, 0
    else:
        m = cap.state.memory
        ti, last, count, lt = (cap.state.curr_ti, cap.state.last_mem_ti, m.work.count,
                               int(m.long.key_valid.sum()))
    writes = 0
    for _ in range(len(cap.frames)):
        ti += 1
        if cap.state is None or ti - last >= mem["mem_every"]:
            last, count, writes = ti, count + hw, writes + 1
            if count >= cw:
                count, lt = mw, min(lt_cap, lt + p)
    got = (after.curr_ti, after.last_mem_ti, after.memory.work.count,
           int(after.memory.long.key_valid.sum()), len(cap.rec["steps"]), len(cap.rec["writes"]))
    return 0.0 if got == (ti, last, count, lt, len(cap.frames), writes) else 1.0


def judge_call(cap: Captured, ref, side, chunk: int, refine: bool, mem: Dict) -> Dict[str, float]:
    """The gaps of one sampled call, stage by stage on the program's own
    inputs: the program's outputs against the reference's, or with `side`
    (the control) the control's."""
    from plainref.inference.refinement import masks_from_prob

    rec, frames, o = cap.rec, cap.frames, cap.n_obj
    me = side is None
    n: Dict[str, float] = {}
    parts = {"key": [], "features": [], "shrinkage": [], "selection": []}
    for k in rec["keys"]:
        r = ref.key_stage(frames[k["step"]])
        sk = k["out"] if me else side.key_stage(frames[k["step"]])
        parts["key"].append(compare.relerr(sk[0], r[0]))
        parts["shrinkage"].append(compare.relerr(sk[1], r[1]))
        parts["selection"].append(compare.relerr(sk[2], r[2]))
        parts["features"].append(_rel(zip(sk[3], r[3])))
    for name, v in parts.items():
        n[f"xmem_{name}_relerr"] = max(v, default=0.0)
    first = [r for r in rec["reads"] if r["step"] == 0]
    n["xmem_read_relerr"] = 0.0
    if cap.state is not None and first:
        r0 = first[0]
        rr = ref.read_stage(cap.state.memory, r0["qk"], r0["qe"], o)
        sr = r0["out"] if me else side.read_stage(cap.state.memory, r0["qk"], r0["qe"], o)
        n["xmem_read_relerr"] = compare.relerr(sr, rr)
    dec = {"decoder": [], "decoder_hidden": [], "decoder_agg": []}
    for i, sg in enumerate(rec["segments"]):
        r = ref.segment_stage(*sg["in"], o)
        sd = tuple(sg["out"]) + (rec["pred"][i]["out"],) if me else side.segment_stage(*sg["in"], o)
        dec["decoder"].append(compare.relerr(sd[3], r[3]))
        if r[0] is not None:
            dec["decoder_hidden"].append(compare.relerr(sd[0], r[0]))
        dec["decoder_agg"].append(compare.relerr(sd[1], r[1]))
    val = {"value": [], "value_trunk": [], "value_hidden": []}
    for i, v in enumerate(rec["values"]):
        r = ref.value_stage(frames[v["step"]], *v["in"], o)
        if me:
            fu = rec["value_fuser"][i]
            sv = tuple(v["out"]) + (fu["in"][1], fu["out"])
        else:
            sv = side.value_stage(frames[v["step"]], *v["in"], o)
        val["value"].append(compare.relerr(sv[3], r[3]))
        val["value_trunk"].append(compare.relerr(sv[2], r[2]))
        if r[1] is not None:
            val["value_hidden"].append(compare.relerr(sv[1], r[1]))
    for name, v in list(dec.items()) + list(val.items()):
        n[f"xmem_{name}_relerr"] = max(v, default=0.0)
    wr = []
    for w in rec["writes"]:
        r = ref.write_stage(w["before"], *w["in"])
        sw = w["after"] if me else side.write_stage(w["before"], *w["in"])
        wr.append(memory_gap(sw, r))
    n["memory_write_mismatch"] = max((g[0] for g in wr), default=0.0)
    n["memory_write_relerr"] = max((g[1] for g in wr), default=0.0)
    n["schedule_mismatch"] = schedule_gap(cap, mem) if me else 0.0

    # the call's answer, from the program's own parts
    answers = [masks_from_prob(st["prob"], o)[1] for st in rec["steps"]]
    if refine and cap.state is not None:
        embs, packs, lowres, iou, emb_gap = [], [], [], [], []
        for g, enc, inputs, dec_ in zip(_groups(len(frames), chunk), rec["encodes"],
                                        rec["refines"], rec["decodes"]):
            fr = torch.from_numpy(np.ascontiguousarray(frames[g])).to(ref.device)
            r_emb = ref.encode(fr)
            s_emb = enc if me else side.encode(fr)
            emb_gap.append(compare.relerr(s_emb.embedding, r_emb.embedding))
            masks, logits, scores, valid = inputs
            r = ref.sam_stage(r_emb, masks, logits, valid)
            if me:
                s = {"coords": dec_[0], "labels": dec_[1], "low_res": dec_[2], "iou": dec_[3]}
                comp = ref.compose(enc, masks, scores, valid, dec_[2], dec_[3], r["has_prompt"])
                for j, f in enumerate(g):
                    answers[f] = comp[j]
            else:
                s = side.sam_stage(s_emb, masks, logits, valid)
            same = ((s["coords"] == r["coords"]).all(-1).all(-1) & (s["labels"] == r["labels"]).all(-1))
            packs.append(float((~same).double().mean()))
            live, tok = r["live"], r["tok"]
            idx = torch.arange(tok.shape[0], device=tok.device)
            if bool(live.any()):
                lowres.append(compare.relerr(s["low_res"][idx, tok][live], r["low_res"][idx, tok][live]))
                iou.append(compare.maxgap(s["iou"][idx, tok][live], r["iou"][idx, tok][live]))
        n["sam_embed_relerr"] = max(emb_gap, default=0.0)
        n["prompt_mismatch"] = max(packs, default=0.0)
        n["sam_lowres_relerr"] = max(lowres, default=0.0)
        n["sam_iou_gap"] = max(iou, default=0.0)
    if me:
        if len(cap.masks) != len(answers):
            n["answer_mismatch"] = 1.0
        else:
            n["answer_mismatch"] = max(compare.mismatch(torch.as_tensor(m), a.cpu())
                                       for m, a in zip(cap.masks, answers))
    else:
        n["answer_mismatch"] = 0.0
    return n


def worst(per_call: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for d in per_call:
        for k, v in d.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


XMEM_NUMBERS = ("xmem_key_relerr", "xmem_features_relerr", "xmem_shrinkage_relerr",
                "xmem_selection_relerr", "xmem_read_relerr", "xmem_decoder_relerr",
                "xmem_decoder_hidden_relerr", "xmem_decoder_agg_relerr", "xmem_value_relerr",
                "xmem_value_trunk_relerr", "xmem_value_hidden_relerr", "memory_write_mismatch",
                "memory_write_relerr", "schedule_mismatch", "answer_mismatch")
SAM_NUMBERS = ("sam_embed_relerr", "prompt_mismatch", "sam_lowres_relerr", "sam_iou_gap")


def _judged(cap, ref, side, chunk, refine, mem) -> Dict[str, float]:
    """`judge_call`, or every number at infinity when the call's outputs
    cannot even be set beside the reference's (a missing frame, a wrong
    shape): such a call is not correct."""
    try:
        return judge_call(cap, ref, side, chunk, refine, mem)
    except (RuntimeError, ValueError, IndexError, KeyError, TypeError):
        traceback.print_exc()
        return dict.fromkeys(XMEM_NUMBERS + (SAM_NUMBERS if refine else ()), math.inf)


def judge(caps: List[Captured], ref, chunk: int, refine: bool, mem: Dict, control=None):
    """The worst gap of each number over the sampled calls, the program's
    against `ref`; with `control` (a reference in a lower precision, put in
    the program's place) also the control's, as a second dict."""
    prog, ctrl = [], []
    for cap in caps:
        prog.append(_judged(cap, ref, None, chunk, refine, mem))
        if control is not None:
            ctrl.append(_judged(cap, ref, control, chunk, refine, mem))
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return worst(prog) if control is None else (worst(prog), worst(ctrl))
