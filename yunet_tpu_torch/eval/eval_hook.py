"""WIDER protocol modes of the eval hook (``yunet_tpu/eval/eval_hook.py``).
The hook itself is not ported yet."""

from __future__ import annotations

from typing import Tuple, Union


def widerface_eval_mode(mode: int) -> Union[str, Tuple[int, int]]:
    """Numeric WIDER protocol mode -> Detector mode, exactly as
    tools/test_widerface.py (reference tools/test_widerface.py:76-97):
    0 = 640x640, 1 = 1650x1100, 2 = origin size, >30 = NxN square."""
    if mode == 0:
        return (640, 640)
    if mode == 1:
        return (1650, 1100)
    if mode == 2:
        return "ORIGIN"
    if mode > 30:
        return (mode, mode)
    raise ValueError(f"bad WIDER eval mode {mode}")
