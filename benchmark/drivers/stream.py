"""One continuing video through the facade's tracker: set-up annotates
frame 0 (`Tracker.track`) and tracks `prefill_frames` more, so that the
window starts with the working memory full, the long-term memory at its
capacity and evictions due; the window then delivers `chunk`-frame slices
(`Tracker.track_batch`). Frames come from a pool played forward and back,
so motion stays continuous. Closed loop, one stream."""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from harness import seeds, tracking
from traffic import generate, schedule


class Call(NamedTuple):
    start: int      # stream frame index of the slice's first frame
    stop: int

    @property
    def units(self) -> int:
        return self.stop - self.start


class Driver:
    unit = "frames"

    def __init__(self, system, spec, seed: int) -> None:
        self.system, self.spec, self.seed = system, spec, seed
        self.tracker = system.model.xmem
        self.chunk = spec["chunk"]
        self.data = generate.stream(spec, seed)
        self.n_pool = len(self.data["pool"])
        self.first = 1 + spec["prefill_frames"]

    def frames(self, a: int, b: int) -> np.ndarray:
        return self.data["pool"][[generate.pingpong(t, self.n_pool) for t in range(a, b)]]

    def call(self, i: int) -> Call:
        a = self.first + i * self.chunk
        return Call(a, a + self.chunk)

    def _masks(self, c: Call) -> List[np.ndarray]:
        masks, _scores = self.tracker.track_batch(list(self.frames(c.start, c.stop)),
                                                  chunk=self.chunk)
        return masks

    def run(self, c: Call) -> None:
        self._masks(c)

    def run_captured(self, c: Call):
        return tracking.run_captured(self.tracker, self.frames(c.start, c.stop),
                                     self.data["objects"], lambda: self._masks(c), False)

    def warm_up(self) -> None:
        """Annotate frame 0 and track the prefill; its chunks are the
        window's shapes. Raises unless the schedule then has evictions due."""
        cfg = self.system.cfg
        h, w = self.spec["height"], self.spec["width"]
        sched = schedule.memory_schedule(self.first, h, w, cfg["memory"])
        if sched["eviction_cycles"] < 1:
            raise ValueError(f"stream traffic: {self.first} frames of set-up reach no "
                             f"long-term eviction ({sched})")
        self.tracker.clear_memory()
        self.tracker.track(self.data["pool"][0], self.data["annotation"])
        for a in range(1, self.first, self.chunk):
            self.tracker.track_batch(list(self.frames(a, min(a + self.chunk, self.first))),
                                     chunk=self.chunk)

    def plan(self) -> List[int]:
        """Sampled calls among the `within` that follow the traced stretch:
        `consolidating_calls` of them where the working memory consolidates
        (and so evicts from the long-term memory), the rest anywhere."""
        chk = self.spec["check"]
        mem = self.system.cfg["memory"]
        r = seeds.rng(self.seed, 22)
        idx = list(range(self.trace_calls(), self.trace_calls() + chk["within"]))
        cons = [i for i in idx
                if any(schedule.consolidates_at(t, mem) for t in range(*self.call(i)[:2]))]
        pick = list(r.choice(cons, chk["consolidating_calls"], replace=False))
        rest = [i for i in idx if i not in pick]
        pick += list(r.choice(rest, chk["calls"] - len(pick), replace=False))
        return sorted(int(i) for i in pick)

    def trace_calls(self) -> int:
        return self.spec["trace"]["calls"]

    def release(self) -> None:
        self.tracker.clear_memory()

    def judge(self, caps, ref, control=None):
        return tracking.judge(caps, ref, self.chunk, self.system.cfg["refinement"]
                              .get("use_refinement", False), self.system.cfg["memory"], control)
