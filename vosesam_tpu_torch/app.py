"""Interactive app session (port of the JAX repo's root `app.py`; reference:
app.py, a 612-line Gradio Blocks UI).

All session logic lives in `AppSession` (plain Python, testable without a
UI); `build_ui()` wires it into Gradio Blocks where gradio is installed.
The reference's behaviours are kept: frame extraction with a RAM guard at
90% (app.py:74-123), template-frame selection re-embedding SAM (:128-147),
click-driven mask refinement (:162-192), multi-mask add / remove
(:194-229), tracking (:232-295), inpainting (:304-331) and video writing
(:335-356). Videos go through the port's `eval/video_io.py`. The model runs
on the card unless it was built with `device="cpu"`.

    python -m vosesam_tpu_torch.app [--device cpu] [--port 12212]

(checkpoints from SAM_CHECKPOINT / XMEM_CHECKPOINT / E2FGVI_CHECKPOINT).
"""

from __future__ import annotations

import os
import sys
import tempfile
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from vosesam_tpu_torch.eval.video_io import _imageio, read_video_frames, write_video
from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything


def get_frames_from_video(path: str, ram_guard: float = 0.9) -> List[np.ndarray]:
    """app.py:74-123: extract frames, stopping at the RAM watermark (where
    psutil is installed to read it; else every frame)."""
    try:
        import psutil
    except ImportError:
        return read_video_frames(path)
    frames = []
    for fr in _imageio().v3.imiter(path):
        frames.append(np.asarray(fr)[..., :3])
        if psutil.virtual_memory().percent >= ram_guard * 100:
            break
    return frames


@dataclass
class AppSession:
    """Session state (video_state / interactive_state / click_state dicts,
    app.py:404-435) plus the callbacks, UI-free."""

    model: TrackingAnything
    frames: List[np.ndarray] = field(default_factory=list)
    template_idx: int = 0
    track_end: Optional[int] = None
    resize_ratio: float = 1.0
    # chunked tracking (chunk 8; None = per frame)
    track_chunk: Optional[int] = 8
    clicks: List[List[float]] = field(default_factory=list)
    click_labels: List[int] = field(default_factory=list)
    masks: List[np.ndarray] = field(default_factory=list)      # saved per object
    current_mask: Optional[np.ndarray] = None
    last_masks: Optional[List[np.ndarray]] = None              # tracking output

    # ------------------------------------------------------------ callbacks
    def load_video(self, path: str) -> int:
        self.frames = get_frames_from_video(path)
        self.template_idx = 0
        self.clicks, self.click_labels, self.masks = [], [], []
        return len(self.frames)

    def select_template(self, idx: int) -> np.ndarray:
        """app.py:128-147: re-embed SAM on the chosen frame."""
        self.template_idx = int(idx)
        self.clicks, self.click_labels = [], []
        self.model.samcontroler.reset_image()
        self.model.samcontroler.set_image(self.frames[self.template_idx])
        return self.frames[self.template_idx]

    def click(self, x: float, y: float, positive: bool) -> np.ndarray:
        """sam_refine (app.py:162-192): accumulate clicks, predict."""
        self.clicks.append([float(x), float(y)])
        self.click_labels.append(1 if positive else 0)
        mask, _logit, painted = self.model.first_frame_click(
            self.frames[self.template_idx],
            np.asarray(self.clicks, np.float32),
            np.asarray(self.click_labels, np.int32),
        )
        self.current_mask = mask
        return painted

    def add_mask(self) -> int:
        """app.py:194-205 multi-object accumulation."""
        if self.current_mask is not None:
            self.masks.append(self.current_mask.copy())
            self.clicks, self.click_labels = [], []
            self.current_mask = None
        return len(self.masks)

    def remove_mask(self) -> int:
        if self.masks:
            self.masks.pop()
        return len(self.masks)

    def template_mask(self, selected: Optional[List[int]] = None) -> np.ndarray:
        """Merge selected masks into one indexed template (app.py:245-253).

        `selected`: indices into the saved mask list (the reference's
        mask_dropdown 'mask_00i' entries); None selects all saved masks (or
        the in-progress click mask)."""
        objs = self.masks if self.masks else (
            [self.current_mask] if self.current_mask is not None else [])
        if selected is not None and self.masks:
            objs = [self.masks[i] for i in selected if 0 <= i < len(self.masks)]
        if not objs:
            raise ValueError("no masks selected")
        out = np.zeros(objs[0].shape, np.uint8)
        for i, m in enumerate(objs):
            out[m > 0] = i + 1
        return out

    def track(self, output_path: Optional[str] = None, selected: Optional[List[int]] = None):
        """vos_tracking_video (app.py:232-295). `resize_ratio != 1` resizes
        the frames (bilinear) and the template (nearest) with Pillow first,
        as the JAX app does; that path needs Pillow."""
        end = self.track_end or len(self.frames)
        frames = self.frames[self.template_idx:end]
        if self.resize_ratio != 1.0:
            import PIL.Image as PILImage

            def rs(f):
                h, w = f.shape[:2]
                return np.asarray(PILImage.fromarray(f).resize(
                    (int(w * self.resize_ratio), int(h * self.resize_ratio))))

            frames = [rs(f) for f in frames]
            tmpl = np.asarray(PILImage.fromarray(self.template_mask(selected)).resize(
                (frames[0].shape[1], frames[0].shape[0]), PILImage.NEAREST))
        else:
            tmpl = self.template_mask(selected)
        self.model.xmem.clear_memory()
        if self.track_chunk:
            masks, painted, scores = self.model.generator_chunked(
                frames, tmpl, chunk=self.track_chunk, paint=True)
        else:
            masks, _logits, painted, scores = self.model.generator(frames, tmpl)
        self.last_masks = masks
        if output_path:
            write_video(output_path, painted, fps=10)
        return masks, painted, scores

    def inpaint(self, masks: List[np.ndarray], output_path: Optional[str] = None):
        """inpaint_video (app.py:304-331). The model's inpainter, or one with
        seeded random weights on the model's device where it has none.

        Where the card runs out of memory (`torch.OutOfMemoryError`, the
        reference's guard, app.py:324-328) the original frames come back and
        one line on stderr says so. Every other error raises: a kernel that
        fails to build or launch is never hidden behind the originals."""
        if self.model.baseinpainter is None:
            from vosesam_tpu_torch.pipeline.inpaint import Inpainter

            self.model.baseinpainter = Inpainter(None, self.model.cfg.inpainter,
                                                 device=self.model.device)
        try:
            out = self.model.baseinpainter.inpaint(self.frames, masks, self.resize_ratio)
        except torch.OutOfMemoryError as e:
            print(f"inpaint: out of device memory, returning the original frames ({e})",
                  file=sys.stderr)
            out = list(self.frames)
        if output_path:
            write_video(output_path, out, fps=10)
        return out


def build_ui(session: AppSession):
    """Gradio Blocks wiring (app.py:483-598). Requires gradio (not installed
    here: the session API above is the tested surface)."""
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed; use AppSession programmatically or "
            "install gradio to launch the UI"
        ) from e

    out_dir = tempfile.gettempdir()
    with gr.Blocks() as demo:
        with gr.Row():
            video_in = gr.Video(label="input video")
            frame_view = gr.Image(label="template frame")
        with gr.Row():
            n_frames = gr.Number(label="frames", precision=0)
            slider = gr.Slider(0, 1, step=1, label="template frame index")
            # track-end + resize-ratio controls (reference app.py:456-470)
            end_slider = gr.Slider(0, 1, step=1, label="track end frame")
            ratio = gr.Slider(0.1, 1.0, value=1.0, step=0.05, label="resize ratio")
        with gr.Row():
            point_mode = gr.Radio(["positive", "negative"], value="positive",
                                  label="point prompt")
            add_btn = gr.Button("add mask")
            remove_btn = gr.Button("remove mask")
            mask_dropdown = gr.Dropdown(multiselect=True, value=[], label="mask selection",
                                        choices=[])
        with gr.Row():
            track_btn = gr.Button("track")
            inpaint_btn = gr.Button("inpaint")
        with gr.Row():
            video_out = gr.Video(label="tracked")
            inpaint_out = gr.Video(label="inpainted")

        def on_video(path):
            n = session.load_video(path)
            mx = max(n - 1, 0)
            return n, gr.update(maximum=mx), gr.update(maximum=mx, value=mx)

        video_in.change(on_video, [video_in], [n_frames, slider, end_slider])
        slider.change(lambda i: session.select_template(int(i)), [slider], [frame_view])

        def on_end(i):
            session.track_end = int(i) + 1
        end_slider.change(on_end, [end_slider], [])

        def on_ratio(r):
            session.resize_ratio = float(r)
        ratio.change(on_ratio, [ratio], [])

        def on_click(mode, evt: "gr.SelectData"):
            x, y = evt.index
            return session.click(x, y, mode == "positive")

        frame_view.select(on_click, [point_mode], [frame_view])

        def choices():
            return [f"mask_{i + 1:03d}" for i in range(len(session.masks))]

        def on_add():
            session.add_mask()
            return gr.update(choices=choices(), value=choices())

        def on_remove():
            session.remove_mask()
            return gr.update(choices=choices(), value=choices())

        add_btn.click(on_add, [], [mask_dropdown])
        remove_btn.click(on_remove, [], [mask_dropdown])

        def on_track(selected):
            out = os.path.join(out_dir, "vosesam_track.mp4")
            idx = [int(s.split("_")[1]) - 1 for s in (selected or [])] or None
            session.track(out, selected=idx)
            return out

        track_btn.click(on_track, [mask_dropdown], [video_out])

        def on_inpaint():
            out = os.path.join(out_dir, "vosesam_inpaint.mp4")
            if session.last_masks is None:
                raise gr.Error("track first — inpainting uses tracked masks")
            session.inpaint(session.last_masks, out)
            return out

        inpaint_btn.click(on_inpaint, [], [inpaint_out])

        # example videos (reference app.py:600-610)
        sample_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  "test_sample")
        if os.path.isdir(sample_dir):
            examples = [os.path.join(sample_dir, f) for f in sorted(os.listdir(sample_dir))
                        if f.endswith(".mp4")]
            if examples:
                gr.Examples(examples=examples, inputs=[video_in])
    return demo


def main(argv=None) -> None:
    import argparse

    from vosesam_tpu_torch.config import FrameworkConfig

    ap = argparse.ArgumentParser(description="The port's interactive app (needs gradio)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--port", type=int, default=int(os.environ.get("PORT", 12212)))
    args = ap.parse_args(argv)
    model = TrackingAnything(
        sam_checkpoint=os.environ.get("SAM_CHECKPOINT"),
        xmem_checkpoint=os.environ.get("XMEM_CHECKPOINT"),
        e2fgvi_checkpoint=os.environ.get("E2FGVI_CHECKPOINT"),
        cfg=FrameworkConfig(), device=args.device)
    demo = build_ui(AppSession(model))
    demo.launch(server_port=args.port)


if __name__ == "__main__":
    main()
