"""The port's server releases its single-flight lock before it writes the
reply (ROADMAP C26), so a client that sends its next request as soon as it
has read a reply is never refused.

A stand-in model answers `/segment` at once. A test-only subclass of the
server's handler holds the handler thread after `_json` has written the
first 200 until the client has sent its next request and read that reply:
the next request must get 200. With the lock released only after the write
(the JAX server's order) it gets `503 busy` instead, every time. A request
that truly overlaps another still gets the 503 with Retry-After.
"""

import base64
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from vosesam_tpu_torch.eval import codec
from vosesam_tpu_torch.serve import server as tserver

HOLD_S = 30.0


class _Controller:
    def reset_image(self):
        pass


class StandIn:
    """Answers `first_frame_click` with a fixed square; `block` (an Event)
    holds a call until it is set."""

    device = torch.device("cpu")

    def __init__(self):
        self.samcontroler = _Controller()
        self.block = None
        self.entered = threading.Event()

    def first_frame_click(self, image, points, labels):
        self.entered.set()
        if self.block is not None:
            assert self.block.wait(HOLD_S)
        if len(points) == 0:
            raise ValueError("no clicks")
        mask = np.zeros(image.shape[:2], bool)
        mask[2:6, 3:9] = True
        return mask, None, image


def post(base, route, payload):
    req = urllib.request.Request(f"{base}{route}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


IMAGE = base64.b64encode(codec.encode_png_rgb(np.zeros((8, 12, 3), np.uint8))).decode()
SEGMENT = {"image": IMAGE, "points": [[4.0, 3.0]], "labels": [1]}


@pytest.fixture
def served():
    model = StandIn()
    httpd = tserver.serve(model, port=0)
    try:
        yield httpd, f"http://127.0.0.1:{httpd.server_address[1]}", model
    finally:
        httpd.shutdown()
        httpd.server_close()


def hold_after_first_reply(httpd, status=200):
    """Swap in a handler that, once, blocks after `_json` has written a
    reply of `status` until `next_done` is set. Returns (held, next_done)."""
    held, next_done = threading.Event(), threading.Event()
    armed = threading.Lock()

    class HoldAfterReply(httpd.RequestHandlerClass):
        def _json(self, code, payload, retry_after=None):
            super()._json(code, payload, retry_after)
            if code == status and armed.acquire(blocking=False):
                held.set()
                assert next_done.wait(HOLD_S)

    httpd.RequestHandlerClass = HoldAfterReply
    return held, next_done


def test_request_sent_right_after_a_reply_gets_200(served):
    httpd, base, _ = served
    held, next_done = hold_after_first_reply(httpd)
    try:
        first = post(base, "/segment", SEGMENT)
        # the first handler thread is still inside its request, after the write
        assert held.wait(HOLD_S)
        second = post(base, "/segment", SEGMENT)
    finally:
        next_done.set()
    assert first[0] == 200
    assert second[0] == 200, f"the next request got {second[0]} {second[1]}"
    assert codec.decode_indices(base64.b64decode(second[1]["mask"])).sum() == 4 * 6


def test_error_reply_releases_the_lock_before_it_is_written(served):
    """A route that raises answers 500; the request sent right after it is
    served."""
    httpd, base, _ = served
    held, next_done = hold_after_first_reply(httpd, status=500)
    try:
        bad = post(base, "/segment", dict(SEGMENT, points=[], labels=[]))
        assert held.wait(HOLD_S)
        good = post(base, "/segment", SEGMENT)
    finally:
        next_done.set()
    assert bad[0] == 500 and bad[1]["error"].startswith("ValueError")
    assert good[0] == 200


def test_inpaint_without_an_inpainter_keeps_its_503(served):
    _, base, _ = served
    code, body, _ = post(base, "/inpaint", {"frames": [], "masks": []})
    assert code == 503 and body["error"].startswith("inpainter not loaded")
    assert post(base, "/segment", SEGMENT)[0] == 200


def test_overlapping_request_still_gets_503_with_retry_after(served):
    _, base, model = served
    model.block = threading.Event()
    first = {}
    th = threading.Thread(target=lambda: first.update(r=post(base, "/segment", SEGMENT)))
    try:
        th.start()
        assert model.entered.wait(HOLD_S), "the first request never reached the model"
        code, body, headers = post(base, "/segment", SEGMENT)
    finally:
        model.block.set()
        th.join(HOLD_S)
    assert not th.is_alive() and first["r"][0] == 200
    assert code == 503 and body["error"].startswith("busy")
    assert headers.get("Retry-After") == "1"


def test_back_to_back_requests_are_never_refused(served):
    _, base, _ = served
    codes = [post(base, "/segment", SEGMENT)[0] for _ in range(50)]
    assert codes == [200] * 50
