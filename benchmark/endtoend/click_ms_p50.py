"""The median latency of all requests in the window, call to results on the
host (a failed request counts as slower than every other)."""

import math

import numpy as np


def value(win, driver):
    if driver.unit != "requests" or not win.latencies:
        return None
    lat = [t * 1e3 if ok else math.inf for t, ok in zip(win.latencies, win.ok)]
    return float(np.percentile(lat, 50))
