"""Process start to the first timed request: imports, the card's start,
kernel builds where none is cached yet, the weights, the traffic's inputs
and the warm-up of every shape the window uses."""


def value(win, driver):
    return win.setup_s
