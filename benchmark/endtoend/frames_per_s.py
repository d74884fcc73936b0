"""All video frames that the cell's pipeline delivered to the host, over the
whole window (the first call to the end of the last)."""


def value(win, driver):
    if driver.unit != "frames":
        return None
    return sum(u for u, ok in zip(win.units, win.ok) if ok) / win.seconds
