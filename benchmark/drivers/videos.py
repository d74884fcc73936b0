"""Videos run back to back through the facade's tracker, as the DAVIS
runner and `TrackingAnything.generator_chunked` drive it: per video
`clear_memory()`, `Tracker.track(frame 0, annotation)`, then
`Tracker.track_batch(slice, chunk)` on successive `chunk`-frame slices, the
video's remainder in its last call. One stream, closed loop: a call starts
when the previous one has returned its masks to the host."""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from harness import seeds, tracking
from traffic import generate, schedule


class Call(NamedTuple):
    video: int
    start: int
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
        self.videos = generate.videos(spec, seed)
        self.cycle: List[Call] = []
        for v, vid in enumerate(self.videos):
            n = len(vid["frames"])
            self.cycle.append(Call(v, 0, 1))
            self.cycle += [Call(v, a, min(a + self.chunk, n)) for a in range(1, n, self.chunk)]

    def call(self, i: int) -> Call:
        return self.cycle[i % len(self.cycle)]

    def _masks(self, c: Call) -> List[np.ndarray]:
        vid = self.videos[c.video]
        if c.start == 0:
            self.tracker.clear_memory()
            m, _logits, _painted, _scores = self.tracker.track(vid["frames"][0], vid["annotation"])
            return [m]
        masks, _scores = self.tracker.track_batch(list(vid["frames"][c.start:c.stop]),
                                                  chunk=self.chunk)
        return masks

    def run(self, c: Call) -> None:
        self._masks(c)

    def run_captured(self, c: Call):
        vid = self.videos[c.video]
        return tracking.run_captured(self.tracker, vid["frames"][c.start:c.stop],
                                     vid["objects"], lambda: self._masks(c), c.start == 0)

    def warm_up(self) -> None:
        """Every shape the window uses: per object count in the pool, the
        annotated frame, one whole chunk and one remainder frame."""
        done = set()
        for v, vid in enumerate(self.videos):
            if vid["objects"] in done:
                continue
            done.add(vid["objects"])
            for c in (Call(v, 0, 1), Call(v, 1, 1 + self.chunk),
                      Call(v, 1 + self.chunk, 2 + self.chunk)):
                self._masks(c)
        self.tracker.clear_memory()

    def plan(self) -> List[int]:
        """Sampled calls among the `within` that follow the traced stretch:
        `first_calls` annotated frames, `consolidating_calls` slices in
        which the working memory consolidates, the rest any slices."""
        chk = self.spec["check"]
        mem = self.system.cfg["memory"]
        r = seeds.rng(self.seed, 21)
        idx = range(self.trace_calls(), self.trace_calls() + chk["within"])
        firsts = [i for i in idx if self.call(i).start == 0]
        cons = [i for i in idx if self.call(i).start != 0 and any(
            schedule.consolidates_at(t, mem) for t in range(self.call(i).start, self.call(i).stop))]
        pick = [int(i) for i in r.choice(firsts, chk["first_calls"], replace=False)]
        pick += [int(i) for i in r.choice(cons, chk["consolidating_calls"], replace=False)]
        others = [i for i in idx if self.call(i).start != 0 and i not in pick]
        pick += [int(i) for i in r.choice(others, chk["calls"] - len(pick), replace=False)]
        return sorted(pick)

    def trace_calls(self) -> int:
        return self.spec["trace"]["calls"]

    def release(self) -> None:
        self.tracker.clear_memory()

    def judge(self, caps, ref, control=None):
        return tracking.judge(caps, ref, self.chunk, self.system.cfg["refinement"]
                              .get("use_refinement", False), self.system.cfg["memory"], control)
