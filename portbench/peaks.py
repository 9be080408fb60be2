"""The table of peaks (``peaks.json``), by a fragment of the device name."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

_TABLE = Path(__file__).resolve().parent / "peaks.json"


def of(device) -> Optional[dict]:
    """The peaks of ``device``'s card, None for a card not in the table
    (or the CPU)."""
    import torch
    if torch.device(device).type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    with open(_TABLE) as f:
        table = json.load(f)
    return next((v for k, v in table.items() if k in name), None)
