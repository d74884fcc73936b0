"""The port's HTTP server (`vosesam_tpu_torch/serve/server.py`), live on an
ephemeral port on the CPU: every route and status (200, 400, 404, 500, 503
busy with Retry-After, 503 without an inpainter), responses equal to the
same facade calls made directly on the same model, and masks that agree
with the JAX server's on the same weights; plus the in-memory PNG codec the
server encodes with.

Both facades hold the same weights: the JAX facade's XMem and SAM-HQ trees
as official-schema files, loaded by the port (TINY SAM of
`tests/test_pipeline.py`, fp32, the score gate off so that SAM's masks are
kept). Server-vs-facade: bit-equal masks and frames and equal scores.
Port-vs-JAX server: masks >= 99.9% equal (fp32 summation order may flip a
logit near 0; ROADMAP C8).
"""

import base64
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from vosesam_tpu.config import FrameworkConfig as JFrameworkConfig
from vosesam_tpu.config import InpainterConfig as JInpainterConfig
from vosesam_tpu.config import MemoryConfig as JMemoryConfig
from vosesam_tpu.config import RefinementConfig as JRefinementConfig
from vosesam_tpu.config import SAMConfig as JSAMConfig
from vosesam_tpu.config import XMemConfig as JXMemConfig
from vosesam_tpu.models.e2fgvi import generator as JG
from vosesam_tpu.pipeline.track_anything import TrackingAnything as JTrackingAnything
from vosesam_tpu.serve import server as jserver
from vosesam_tpu.utils.checkpoint import tree_to_state_dict
from vosesam_tpu_torch.config import (
    FrameworkConfig,
    InpainterConfig,
    MemoryConfig,
    RefinementConfig,
    SAMConfig,
    XMemConfig,
)
from vosesam_tpu_torch.eval import codec
from vosesam_tpu_torch.eval.palette import pascal_colormap
from vosesam_tpu_torch.models.e2fgvi import generator as TG
from vosesam_tpu_torch.pipeline.inpaint import Inpainter
from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything
from vosesam_tpu_torch.serve import server as tserver
from vosesam_tpu_torch.utils.checkpoint import params_from_jax

H, W = 48, 64
N_FRAMES = 5
AGREEMENT = 0.999
TINY = dict(model_type="vit_b", image_size=128, window_size=7,
            vit_dims=(("vit_b", 64, 2, 2, (1,)),), hq=True, encode_rect=True)
MEM = dict(max_mid_term_frames=3, min_mid_term_frames=2, max_long_term_elements=64,
           num_prototypes=8, top_k=8, mem_every=2)
RK = dict(mode="both_neg", point_algorithm="C", min_region_area=10.0, optimized=False)
CONVT = {f"mask_decoder.{m}.{i}.weight": "conv_transpose"
         for m in ("output_upscaling", "compress_vit_feat", "embedding_encoder") for i in (0, 3)}


def jax_cfg():
    return JFrameworkConfig(xmem=JXMemConfig(max_objects=2), memory=JMemoryConfig(**MEM),
                            sam=JSAMConfig(**TINY), refinement=JRefinementConfig(**RK),
                            dtype="float32")


def port_cfg():
    return FrameworkConfig(xmem=XMemConfig(max_objects=2), memory=MemoryConfig(**MEM),
                           sam=SAMConfig(**TINY), refinement=RefinementConfig(**RK),
                           dtype="float32")


def clip(n=N_FRAMES, h=H, w=W):
    r = np.random.default_rng(0)
    base = r.integers(0, 255, (h, w, 3), np.uint8)
    frames = []
    for i in range(n):
        f = base.copy()
        f[6 + i:20 + i, 4 + 2 * i:24 + 2 * i] = (220, 60, 60)
        f[28:42, 40 - i:60 - i] = (60, 200, 220)
        frames.append(f)
    seed = np.zeros((h, w), np.uint8)
    seed[6:20, 4:24] = 1
    seed[28:42, 40:60] = 2
    return frames, seed


def save_jax_weights(jta, d):
    """The JAX facade's XMem and SAM-HQ trees as official-schema files."""
    xpath, spath = d / "xmem.pth", d / "sam_hq.pth"
    torch.save(params_from_jax(jax.tree.map(np.asarray, jta.xmem_params)), xpath)
    sd = tree_to_state_dict(jax.tree.map(np.asarray, jta.sam_params)._asdict(),
                            transpose_spec=CONVT)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, spath)
    return str(xpath), str(spath)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    jta = JTrackingAnything(cfg=jax_cfg())
    xpath, spath = save_jax_weights(jta, tmp_path_factory.mktemp("ckpt"))
    tta = TrackingAnything(sam_checkpoint=spath, xmem_checkpoint=xpath, cfg=port_cfg(),
                           device="cpu")
    return jta, tta


@pytest.fixture(scope="module")
def server(models):
    _, tta = models
    httpd = tserver.serve(tta, port=0)
    yield httpd, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def jax_server(models):
    jta, _ = models
    httpd = jserver.serve(jta, port=0)
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def b64_png(rgb):
    return base64.b64encode(codec.encode_png_rgb(rgb)).decode()


def b64_mask(mask):
    return base64.b64encode(codec.encode_png_palette(mask, pascal_colormap())).decode()


def mask_of(b64):
    return codec.decode_indices(base64.b64decode(b64))


def post(base, route, payload, raw=None):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(f"{base}{route}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def http_error(fn):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn()
    return e.value.code, json.loads(e.value.read()), e.value.headers


def wait_lock_free(httpd, timeout=10.0):
    """The lock is released just after the response is written: wait it out."""
    t0 = time.perf_counter()
    while httpd.RequestHandlerClass.lock.locked():
        assert time.perf_counter() - t0 < timeout, "lock stuck"
        time.sleep(0.01)


SEGMENT = dict(points=[[14.0, 12.0], [50.0, 35.0]], labels=[1, 0])


# ------------------------------------------------------------------ routes

def test_health(server):
    _, base = server
    with urllib.request.urlopen(f"{base}/health", timeout=60) as r:
        assert r.status == 200
        assert json.loads(r.read()) == {"status": "ok", "backend": "cpu", "device": "cpu"}


@pytest.mark.parametrize("method", ["GET", "POST"])
def test_unknown_route_404(server, method):
    _, base = server
    data = b"{}" if method == "POST" else None
    req = urllib.request.Request(f"{base}/nope", data=data, method=method)
    code, body, _ = http_error(lambda: urllib.request.urlopen(req, timeout=60))
    assert code == 404 and body == {"error": "unknown route"}


def test_bad_json_400(server):
    _, base = server
    code, body, _ = http_error(lambda: post(base, "/track", None, raw=b"{not json"))
    assert code == 400 and body["error"].startswith("bad json")


def test_route_error_500_names_the_exception(server):
    httpd, base = server
    code, body, _ = http_error(lambda: post(base, "/segment", {"points": [[1, 2]]}))
    assert code == 500 and body["error"].startswith("KeyError")
    wait_lock_free(httpd)
    assert not httpd.RequestHandlerClass.lock.locked()


def test_segment_equals_the_facade(server, models):
    httpd, base = server
    _, tta = models
    frames, _ = clip()
    status, out = post(base, "/segment", dict(SEGMENT, image=b64_png(frames[0])))
    wait_lock_free(httpd)
    assert status == 200 and out["shape"] == [H, W]
    got = mask_of(out["mask"])
    tta.samcontroler.reset_image()
    want, _, _ = tta.first_frame_click(frames[0], np.asarray(SEGMENT["points"], np.float32),
                                       np.asarray(SEGMENT["labels"], np.int32))
    np.testing.assert_array_equal(got, want.astype(np.uint8))
    assert got.any()


def test_segment_jpeg_request(server, models):
    """A JPEG image decodes through the codec's JPEG route."""
    httpd, base = server
    _, tta = models
    frames, _ = clip()
    import io

    buf = io.BytesIO()
    Image.fromarray(frames[0]).save(buf, format="JPEG", quality=95)
    status, out = post(base, "/segment", dict(SEGMENT, image=base64.b64encode(
        buf.getvalue()).decode()))
    wait_lock_free(httpd)
    assert status == 200
    image = codec.decode_rgb(buf.getvalue())
    tta.samcontroler.reset_image()
    want, _, _ = tta.first_frame_click(image, np.asarray(SEGMENT["points"], np.float32),
                                       np.asarray(SEGMENT["labels"], np.int32))
    np.testing.assert_array_equal(mask_of(out["mask"]), want.astype(np.uint8))


@pytest.mark.parametrize("chunk", [None, 0, 2])
def test_track_equals_the_facade(server, models, chunk):
    """Default chunk 8 (one chunk does not fill: per frame after the seed),
    chunk 0 (the per-frame generator) and chunk 2 (two full chunks)."""
    httpd, base = server
    _, tta = models
    frames, seed = clip()
    payload = {"frames": [b64_png(f) for f in frames], "template_mask": b64_mask(seed)}
    if chunk is not None:
        payload["chunk"] = chunk
    status, out = post(base, "/track", payload)
    wait_lock_free(httpd)
    assert status == 200 and len(out["masks"]) == N_FRAMES
    tta.xmem.clear_memory()
    c = 8 if chunk is None else chunk
    if c > 1:
        want, scores = tta.generator_chunked(frames, seed, chunk=c)
    else:
        want, _, _, scores = tta.generator(frames, seed)
    for m_b64, m in zip(out["masks"], want):
        np.testing.assert_array_equal(mask_of(m_b64), m)
    assert out["scores"] == [list(map(float, s)) for s in scores]


def test_track_agrees_with_the_jax_server(server, jax_server):
    httpd, base = server
    frames, seed = clip()
    payload = {"frames": [b64_png(f) for f in frames], "template_mask": b64_mask(seed),
               "chunk": 2}
    _, got = post(base, "/track", payload)
    wait_lock_free(httpd)
    _, want = post(jax_server, "/track", payload)
    for g, w in zip(got["masks"], want["masks"]):
        assert (mask_of(g) == mask_of(w)).mean() >= AGREEMENT
    assert [len(s) for s in got["scores"]] == [len(s) for s in want["scores"]]
    for g, w in zip(got["scores"], want["scores"]):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
    _, got = post(base, "/segment", dict(SEGMENT, image=b64_png(frames[0])))
    wait_lock_free(httpd)
    _, want = post(jax_server, "/segment", dict(SEGMENT, image=b64_png(frames[0])))
    assert (mask_of(got["mask"]) == mask_of(want["mask"])).mean() >= AGREEMENT


def test_inpaint_503_then_equal_to_the_facade(server, models):
    httpd, base = server
    _, tta = models
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 255, (60, 108, 3), np.uint8) for _ in range(3)]
    hole = np.zeros((60, 108), np.uint8)
    hole[20:35, 40:70] = 1
    payload = {"frames": [b64_png(f) for f in frames], "masks": [b64_mask(hole)] * 3,
               "dilate_radius": 2}
    code, body, _ = http_error(lambda: post(base, "/inpaint", payload))
    assert code == 503 and "inpainter" in body["error"]
    wait_lock_free(httpd)
    cfg = InpainterConfig(num_blocks=1, static_windows=True)
    jparams = JG.generator_init(jax.random.PRNGKey(0), JInpainterConfig(num_blocks=1))
    net = TG.InpaintGenerator(cfg)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)), strict=True)
    tta.baseinpainter = Inpainter(cfg=cfg, net=net, device="cpu")
    try:
        status, out = post(base, "/inpaint", dict(payload, ratio=1.0))
        wait_lock_free(httpd)
        assert status == 200 and len(out["frames"]) == 3
        want = tta.baseinpainter.inpaint(frames, [hole] * 3, ratio=1.0, dilate_radius=2)
        for b, w in zip(out["frames"], want):
            got = codec.decode_rgb(base64.b64decode(b))
            assert got.shape == (60, 108, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, w)
    finally:
        tta.baseinpainter = None


def test_busy_503_single_flight(server, models):
    """Two concurrent /track requests: the in-flight one wins, the other gets
    an immediate 503 with Retry-After; a retry after it completes succeeds."""
    httpd, base = server
    _, tta = models
    frames, seed = clip(3)
    payload = {"frames": [b64_png(f) for f in frames], "template_mask": b64_mask(seed)}
    orig = tta.generator_chunked
    entered, release = threading.Event(), threading.Event()

    def held(*a, **k):
        entered.set()
        assert release.wait(60)
        return orig(*a, **k)

    first = {}

    def client_a():
        first["status"] = post(base, "/track", payload)[0]

    tta.generator_chunked = held
    th = threading.Thread(target=client_a)
    try:
        th.start()
        assert entered.wait(60), "the first request never reached the model"
        t0 = time.perf_counter()
        code, body, headers = http_error(lambda: post(base, "/track", payload))
        busy_wall = time.perf_counter() - t0
        assert code == 503 and body["error"].startswith("busy")
        assert headers.get("Retry-After") == "1"
        assert busy_wall < 5.0, f"busy reply took {busy_wall:.2f} s: queued, not refused"
    finally:
        release.set()
        th.join(120)
        del tta.generator_chunked
    assert not th.is_alive() and first["status"] == 200
    wait_lock_free(httpd)
    assert post(base, "/track", payload)[0] == 200
    wait_lock_free(httpd)


def test_servers_do_not_share_models_or_locks(models):
    _, tta = models
    a, b = tserver.serve(tta, port=0), tserver.serve(tta, port=0)
    try:
        assert a.RequestHandlerClass.lock is not b.RequestHandlerClass.lock
        assert a.RequestHandlerClass.model is tta and tserver.InferenceHandler.model is None
    finally:
        for s in (a, b):
            s.shutdown()
            s.server_close()


def test_main_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: main would serve on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserver.main(["--port", "0"])


# --------------------------------------------------- the in-memory codec

def test_png_bytes_equal_the_files_and_pillow_reads_them(tmp_path):
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 255, (13, 17, 3), np.uint8)
    idx = rng.integers(0, 5, (13, 17)).astype(np.uint8)
    codec.write_png_rgb(str(tmp_path / "a.png"), rgb)
    codec.write_png_palette(str(tmp_path / "b.png"), idx, pascal_colormap())
    assert (tmp_path / "a.png").read_bytes() == codec.encode_png_rgb(rgb)
    assert (tmp_path / "b.png").read_bytes() == codec.encode_png_palette(idx, pascal_colormap())
    np.testing.assert_array_equal(codec.decode_rgb(codec.encode_png_rgb(rgb)), rgb)
    np.testing.assert_array_equal(codec.decode_indices(
        codec.encode_png_palette(idx, pascal_colormap())), idx)
    np.testing.assert_array_equal(np.array(Image.open(tmp_path / "a.png")), rgb)
    pil = Image.open(tmp_path / "b.png")
    assert pil.mode == "P"
    np.testing.assert_array_equal(np.array(pil), idx)
    # and the JAX server's Pillow-encoded masks decode to the same indices
    jb64 = jserver._encode_mask(idx)
    np.testing.assert_array_equal(mask_of(jb64), idx)
