"""Click sessions through the facade: a session is
`samcontroler.reset_image()` and then one `first_frame_click(image,
points, labels)` per click, the point history growing by one click; the
first request of a session pays `set_image`. A request ends when its mask,
low-res logit and painted frame are on the host. Closed loop, one user, no
think time."""

from __future__ import annotations

import math
import traceback
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from harness import compare, seeds
from traffic import generate

# sessions generated in set-up: more than any window of this traffic reaches
_SESSIONS = 4000


class Call(NamedTuple):
    session: int
    clicks: int      # this request sends the session's first `clicks` points
    units: int = 1


class Driver:
    unit = "requests"

    def __init__(self, system, spec, seed: int) -> None:
        self.system, self.spec, self.seed = system, spec, seed
        self.model = system.model
        self.data = generate.clicks(spec, seed, _SESSIONS)
        self.calls: List[Call] = [Call(s, p + 1)
                                  for s, sess in enumerate(self.data["sessions"])
                                  for p in range(len(sess["labels"]))]

    def call(self, i: int) -> Call:
        return self.calls[i % len(self.calls)]

    def _request(self, c: Call):
        sess = self.data["sessions"][c.session]
        if c.clicks == 1:
            self.model.samcontroler.reset_image()
        return self.model.first_frame_click(self.data["images"][sess["image"]],
                                            sess["points"][:c.clicks], sess["labels"][:c.clicks])

    def run(self, c: Call) -> None:
        self._request(c)

    def run_captured(self, c: Call) -> Dict:
        mask, logit, _painted = self._request(c)
        sess = self.data["sessions"][c.session]
        return {"image": sess["image"], "points": sess["points"][:c.clicks],
                "labels": sess["labels"][:c.clicks], "mask": mask, "logit": logit,
                "emb": self.model.samcontroler.emb.embedding}

    def warm_up(self) -> None:
        """set_image at batch 1, a one-pass click and a two-pass click."""
        img = self.data["images"][0]
        pts = np.array([[100.0, 100.0], [400.0, 300.0], [120.0, 110.0]], np.float32)
        for lbl in ([1], [1, 0], [1, 0, 1]):
            self.model.samcontroler.reset_image()
            self.model.first_frame_click(img, pts[:len(lbl)], np.array(lbl, np.int64))

    def plan(self) -> List[int]:
        """Sampled requests among the `within` that follow the traced
        stretch: one with the longest history, the rest anywhere."""
        chk = self.spec["check"]
        r = seeds.rng(self.seed, 23)
        idx = list(range(self.trace_calls(), self.trace_calls() + chk["within"]))
        longest = max(self.call(i).clicks for i in idx)
        pick = [int(r.choice([i for i in idx if self.call(i).clicks == longest]))]
        rest = [i for i in idx if i not in pick]
        pick += [int(i) for i in r.choice(rest, chk["requests"] - 1, replace=False)]
        return sorted(pick)

    def trace_calls(self) -> int:
        return self.spec["trace"]["requests"]

    def release(self) -> None:
        self.model.samcontroler.reset_image()

    def judge(self, caps, ref, control=None):
        """Worst gaps over the sampled requests: the mask, the low-res logit
        and the image embedding, each against the reference's; with
        `control`, the control's too, as a second dict."""
        names = ("click_mask_mismatch", "click_logit_relerr", "click_embed_relerr")
        prog = dict.fromkeys(names, 0.0)
        ctrl = dict.fromkeys(names, 0.0)
        embs: Dict[int, tuple] = {}
        for cap in caps:
            img = self.data["images"][cap["image"]]
            if cap["image"] not in embs:
                up = torch.from_numpy(np.ascontiguousarray(img[None])).to(ref.device)
                embs[cap["image"]] = (ref.encode(up),
                                      None if control is None else control.encode(up))
            r_emb, c_emb = embs[cap["image"]]
            r_mask, r_logit = ref.click(r_emb, img, cap["points"], cap["labels"])
            sides = [(prog, cap["mask"], cap["logit"], cap["emb"])]
            if control is not None:
                c_mask, c_logit = control.click(c_emb, img, cap["points"], cap["labels"])
                sides.append((ctrl, c_mask, c_logit, c_emb.embedding))
            for out, mask, logit, emb in sides:
                try:
                    gaps = (compare.mismatch(torch.as_tensor(mask).cpu(), r_mask.cpu()),
                            compare.relerr(torch.as_tensor(logit).cpu(), r_logit.cpu()),
                            compare.relerr(emb, r_emb.embedding))
                except RuntimeError:     # an answer of the wrong shape is not correct
                    traceback.print_exc()
                    gaps = (math.inf,) * 3
                for k, g in zip(names, gaps):
                    out[k] = max(out[k], g)
        return prog if control is None else (prog, ctrl)
