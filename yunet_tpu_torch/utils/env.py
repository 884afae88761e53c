"""Environment fingerprint + process setup — counterpart of
``yunet_tpu/utils/env.py``.

collect_env mirrors the reference startup logging (utils/collect_env.py,
logged at tools/train.py:184-190) with torch, CUDA, the card and nvcc in
place of JAX, optax and orbax; setup_multi_processes mirrors
utils/setup_env.py:10-53 (thread caps so the data-loader worker pool does
not oversubscribe the host). JAX's enable_compilation_cache is XLA's and
has no counterpart here.
"""

from __future__ import annotations

import os
import platform
import subprocess
import sys
from typing import Dict


def _nvcc_version() -> str:
    from ..ops._build import nvcc_path
    try:
        out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                             text=True, timeout=30)
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"
    lines = out.stdout.strip().splitlines()
    return lines[-1] if lines else "unavailable"


def collect_env() -> Dict[str, str]:
    import numpy
    import torch

    info = {
        "sys.platform": sys.platform,
        "Python": sys.version.replace("\n", ""),
        "Machine": platform.machine(),
        "PyTorch": torch.__version__,
        "CUDA (torch build)": str(torch.version.cuda),
        "CUDA available": str(torch.cuda.is_available()),
    }
    if torch.cuda.is_available():
        info["GPU 0"] = torch.cuda.get_device_name(0)
        info["GPU count"] = str(torch.cuda.device_count())
    info["nvcc"] = _nvcc_version()
    info["numpy"] = numpy.__version__
    from .. import __version__
    info["yunet_tpu_torch"] = __version__
    return info


def env_string() -> str:
    return "\n".join(f"{k}: {v}" for k, v in collect_env().items())


def setup_multi_processes() -> None:
    """Cap math-library threads so loader workers don't oversubscribe
    cores (reference setup_env.py:26-53). The workers also run torch on
    one thread each (data/loader.py:_worker_init)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
