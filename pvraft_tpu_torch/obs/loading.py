"""The file contract of a committed JSON artifact (port of
``pvraft_tpu/obs/loading.py``), shared by every validator of the port.

:func:`load_json_artifact` reads a whole-file JSON document; with
``one_line=True`` the file must hold exactly one non-blank JSON line.
An unreadable or malformed file comes back as ``(None, [problem])``,
never as a traceback: a validator's verdict is its problem list."""

from __future__ import annotations

import json
from typing import Any, List, Optional, Tuple


def load_json_artifact(path: str, one_line: bool = False
                       ) -> Tuple[Optional[Any], List[str]]:
    """``(doc, problems)`` of one JSON artifact: ``doc`` is None exactly
    when ``problems`` is non-empty. The schema is the caller's."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
    except OSError as e:
        return None, [f"{path}: unreadable: {e}"]
    if one_line:
        lines = [line for line in text.splitlines() if line.strip()]
        if len(lines) != 1:
            return None, [
                f"{path}: expected exactly one JSON line, got {len(lines)}"]
        text = lines[0]
    try:
        return json.loads(text), []
    except ValueError as e:
        return None, [f"{path}: not valid JSON: {e}"]
