"""Tolerant JSONL reading (port of ``hyperscalees_t2i_tpu/utils/jsonl.py``):
a torn tail or a stray non-JSON line is skipped, never fatal."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Union


def read_jsonl_rows(path: Union[str, Path]) -> List[Dict[str, Any]]:
    """The object rows of a JSONL file in file order; a missing file gives
    ``[]``."""
    try:
        text = Path(path).read_text()
    except OSError:
        return []
    rows: List[Dict[str, Any]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            rows.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return rows
