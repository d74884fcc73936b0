"""The whole tracking step's work, counted from the plain reference's
algorithm at the shapes of each call: the XMem key encoder, value encoder
(memory frames) and decoder counted by `torch.utils.flop_counter` on the
reference's modules built on the meta device (no data, no kernel), the
memory read by `memory_read.read_work`, the SAM encode by
`encode.algorithm_encode_flops` and the SAM-HQ prompt encoder and mask
decoder by the same counter. Counts are cached by shape."""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from roofline import encode, memory_read


def _count(fn) -> float:
    with FlopCounterMode(display=False) as fcm:
        fn()
    return float(fcm.get_total_flops())


class StepFlops:
    """FLOPs of the parts of a step for one configuration file."""

    def __init__(self, cfg: Dict) -> None:
        import harness  # noqa: F401  (puts the reference on the path)
        from harness import configs
        from plainref import config as RC
        from plainref.models.sam.predictor import Sam
        from plainref.models.xmem.network import XMem

        self.cfg = cfg
        self.fc = configs.framework(cfg, RC, dtype="float32")
        with torch.device("meta"):
            self.net = XMem(self.fc.xmem)
            self.sam = Sam(self.fc.sam) if configs.refines(cfg) else None

    @functools.lru_cache(maxsize=None)
    def xmem(self, h: int, w: int, objects: int, memory_frame: bool) -> float:
        """Key encoder and decoder of one frame (value encoder too on a
        memory frame); the read is counted apart."""
        from plainref.models.xmem import network as xnet

        ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
        x = self.fc.xmem
        m = lambda *s, **k: torch.empty(*s, device="meta", **k)  # noqa: E731
        f = m(ph, pw, 3)
        feats = xnet.encode_key(self.net, f)[3]
        hid = m(objects, ph // 16, pw // 16, x.hidden_dim)
        valid = m(objects, dtype=torch.bool)
        total = _count(lambda: xnet.encode_key(self.net, f))
        total += _count(lambda: xnet.segment(self.net, feats, m(objects, ph // 16, pw // 16,
                                                                   x.value_dim),
                                             hid, valid, x, h_out=True))
        if memory_frame:
            total += _count(lambda: xnet.encode_value(self.net, f, feats.f16, hid,
                                                      m(objects, ph, pw), valid, x,
                                                      is_deep_update=True))
        return total

    def read(self, q: int, m: int, objects: int) -> float:
        x = self.fc.xmem
        return memory_read.read_work(q, m, x.key_dim, x.value_dim, objects,
                                     self.fc.memory.top_k, 2)[0]

    def encode(self, grid: Tuple[int, int]) -> float:
        s = self.fc.sam
        dim, depth, heads, glb = s.encoder_dims()
        return encode.algorithm_encode_flops(dim, depth, heads, glb, s.window_size,
                                             s.patch_size, grid)

    @functools.lru_cache(maxsize=None)
    def decode(self, packs: int, points: int, grid: Tuple[int, int], mask_prompt: bool,
               frames: int = 1) -> float:
        """SAM-HQ's prompt encoder and mask decoder on `packs` prompt packs
        of `points` points over `frames` frames' embeddings (the packs spread
        evenly over the frames)."""
        from plainref.models.sam import predictor

        m = lambda *s, **k: torch.empty(*s, device="meta", **k)  # noqa: E731
        dim = self.fc.sam.encoder_dims()[0]
        gh, gw = grid
        emb = predictor.ImageEmbedding(m(frames, gh, gw, 256),
                                       m(frames, gh, gw, dim) if self.fc.sam.hq else None,
                                       (gh * 16, gw * 16), (gh * 16, gw * 16))
        mask = m(packs, gh * 4, gw * 4) if mask_prompt else None
        return _count(lambda: predictor.predict_low_res(
            self.sam, emb, m(packs, points, 2), m(packs, points, dtype=torch.long), mask,
            self.fc.sam, frame_of=m(packs, dtype=torch.long)))
