"""The measured window: a closed loop over the traffic driver's calls, timed by
the host's clock from the call to its results on the host, for `seconds`
seconds and then to the end of the call in flight. Sampled calls run with
their capture; in a traced run a stretch of calls runs under the profiler
with the layer ranges open."""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field
from typing import List, Optional

from harness import tracing


@dataclass
class Window:
    seconds: float = 0.0            # from the first call to the end of the last
    latencies: List[float] = field(default_factory=list)   # per call, seconds
    ends: List[float] = field(default_factory=list)        # per call, seconds into the window
    units: List[int] = field(default_factory=list)         # frames or requests per call
    ok: List[bool] = field(default_factory=list)
    captures: list = field(default_factory=list)
    traced_units: int = 0
    trace_path: Optional[str] = None
    setup_s: float = 0.0


def run(driver, seconds: float, plan: List[int], ranges: Optional[tracing.Ranges] = None,
        trace_calls: int = 0) -> Window:
    win = Window()
    last = max(plan, default=-1)
    plan = set(plan)
    prof = None
    t0 = time.perf_counter()
    i = 0
    while True:
        c = driver.call(i)
        if ranges is not None and i == 0:
            prof = tracing.Profiler()
            prof.start()
            ranges.active = True
        ts = time.perf_counter()
        ok = True
        try:
            if i in plan:
                win.captures.append(driver.run_captured(c))
            else:
                driver.run(c)
        except Exception:       # a failed call counts against the attempted ones
            ok = False
            traceback.print_exc()
        te = time.perf_counter()
        win.latencies.append(te - ts)
        win.ends.append(te - t0)
        win.units.append(c.units)
        win.ok.append(ok)
        if prof is not None and i < trace_calls:
            win.traced_units += c.units if ok else 0
            if i == trace_calls - 1:
                ranges.active = False
                win.trace_path = prof.stop()
                prof = None
        i += 1
        if te - t0 >= seconds and prof is None and i > last:
            break
    win.seconds = te - t0
    return win


def rates(win: Window, step: float = 5.0) -> List[float]:
    """Units completed per second in each `step`-second stretch of the
    window (a call counted in the stretch where it ended), to show whether
    a run's pace drifts within it."""
    n = max(1, int(win.seconds // step))
    done = [0] * n
    for t, u in zip(win.ends, win.units):
        done[min(n - 1, int(t // step))] += u
    return [d / step for d in done[:-1]] + [done[-1] / (win.seconds - step * (n - 1))]
