"""Host time of the tracker loop's own work, per frame delivered: the
program's `track.upload` (frames, masks and flags to the card), `track.masks`
(masks and scores from the step's probabilities, their stacking) and
`track.remap` (painting, the label remap and the live scores) spans."""

# the program's own spans: no wrapped range
LAYERS = ()
SPANS = ("track.upload", "track.masks", "track.remap")


def read(tv):
    t = sum(tv.layer_host_s(s) for s in SPANS)
    if not tv.frames or t <= 0:
        return None
    return t * 1e3 / tv.frames
