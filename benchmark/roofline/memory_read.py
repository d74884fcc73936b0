"""The XMem memory read's work over the valid memory slots that these inputs
need: the similarity of Q query tokens against M valid keys (XMem's
shrinkage- and selection-weighted negative squared distance: the two
(Q, Ck) x (Ck, M) products that carry it), the top-k softmax, and the
readout of the k kept slots' values for each live object; the bytes of
the keys, shrinkage, values, queries and output, each moved once."""

from __future__ import annotations

from typing import Tuple


def read_work(q: int, m: int, ck: int, cv: int, objects: int, top_k: int,
              itemsize: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one read."""
    k = min(top_k, m)
    flops = 4 * q * m * ck + 2 * objects * q * k * cv
    bytes_moved = itemsize * (m * ck + m + objects * m * cv + 2 * q * ck + objects * q * cv)
    return float(flops), float(bytes_moved)
