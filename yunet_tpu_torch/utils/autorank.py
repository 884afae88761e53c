"""AP leaderboard file — reference tools/auto_rank_result.py:5-80 parity.
A copy of ``yunet_tpu/utils/autorank.py`` (json only).

Appends evaluation results to a text log kept sorted by a chosen metric so
repeated WIDER runs act as a manual regression tracker.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List


class AutoRank:
    def __init__(self, path: str = "./eval.log", sort_key: str = "hard"):
        self.path = path
        self.sort_key = sort_key

    def _read(self) -> List[Dict]:
        if not os.path.exists(self.path):
            return []
        rows = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        rows.append(json.loads(line))
                    except json.JSONDecodeError:
                        pass
        return rows

    def update(self, aps: Dict[str, float], tag: str = "") -> None:
        rows = self._read()
        rows.append({"time": time.strftime("%Y-%m-%d %H:%M:%S"),
                     "tag": tag, **{k: round(float(v), 5)
                                    for k, v in aps.items()}})
        rows.sort(key=lambda r: -r.get(self.sort_key, 0.0))
        with open(self.path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
