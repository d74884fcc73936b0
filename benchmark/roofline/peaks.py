"""Published peaks of the card a run is on (`peaks.json`), by its name."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))


def for_card(kind: str) -> Optional[Dict]:
    with open(os.path.join(_HERE, "peaks.json")) as f:
        table = json.load(f)
    for entry in table.values():
        if entry["match"] in kind:
            return entry
    return None
