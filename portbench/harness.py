"""What every cell shares: finding a cell's files by the names in
``BENCHMARK.json``, the weights, the port's configuration and the check
that no JAX module is loaded.

A cell names a configuration (``configs/<name>.json``), a traffic mix
(``traffic/<name>.json``, whose ``driver`` names a module of
``drivers/``). Its end-to-end metrics are the ones its driver takes
(``Driver.reports``) and ``setup_s``; its per-layer metrics are those
of ``BENCHMARK.json`` that move one of them, each ``<base>.<scope>``
read by ``metrics/<base>.py``. Its limits are in
``limits/<cell>.json``. Adding a cell, mix, configuration or metric adds
files and entries; none of this code changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys
from typing import Dict, List, Optional

PB_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB_DIR)
OUT_DIR = os.path.join(PB_DIR, "out")
FORBIDDEN = ("jax", "jaxlib", "flax", "yunet_tpu")
SLICE = "portbench.slice"


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


class Bench:
    """BENCHMARK.json and the files it names, looked up by name."""

    def __init__(self, root: str = ROOT, pb_dir: str = PB_DIR):
        self.root, self.pb_dir = root, pb_dir
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name}")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no configuration named {name}")

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.pb_dir, "traffic", name + ".json"))

    def limits(self, workload: str) -> Dict[str, float]:
        return load_json(os.path.join(self.pb_dir, "limits",
                                      workload + ".json"))["limits"]

    def driver(self, workload: str):
        """The driver class of the cell's traffic mix."""
        return driver_class(
            self.traffic(self.workload(workload)["traffic"])["driver"])

    def end_to_end(self, workload: str) -> List[dict]:
        """The end-to-end metrics this cell reports: setup_s and those
        its driver takes."""
        took = set(self.driver(workload).reports) | {"setup_s"}
        return [m for m in self.spec["end_to_end"] if m["name"] in took]

    def per_layer(self, workload: str) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it,
        and those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.spec["per_layer"]
                if workload in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in e2e)]


def driver_class(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}").Driver


def metric_reader(name: str):
    """``metrics/<base>.py``'s ``read`` for a metric ``<base>.<scope>``."""
    return importlib.import_module(
        f"portbench.metrics.{name.split('.')[0]}").read


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that the benchmark must never
    load: JAX, its libraries and the JAX package (whole names, so
    yunet_tpu_torch passes)."""
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


# -- the port's side ----------------------------------------------------------

def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def port_config(cfg: dict):
    """The port's Config (``yunet_tpu_torch.config``) holding the
    configuration file's groups."""
    from yunet_tpu_torch import config as pc

    def group(cls, key):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: _tuples(v) for k, v in cfg[key].items()
                      if k in names})
    return pc.Config(model=group(pc.ModelConfig, "model"),
                     loss=group(pc.LossConfig, "loss"),
                     assigner=group(pc.AssignerConfig, "assigner"),
                     test=group(pc.TestConfig, "test"),
                     train=group(pc.TrainConfig, "train"))


def port_state_dict(sd):
    """The benchmark's state dict as the port's modules load it: with
    BatchNorm's batch counters."""
    import torch
    out = dict(sd)
    for k in sd:
        if k.endswith(".running_mean"):
            out[k[: -len("running_mean")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.int64, device=sd[k].device)
    return out


def weights(cfg: dict, device):
    """The configuration's weights on ``device``, f32, read from its
    file."""
    import numpy as np
    import torch
    from .reference.model import param_shapes
    with np.load(os.path.join(ROOT, cfg["weights"])) as blob:
        return {n: torch.from_numpy(blob[n]).to(device)
                for n, _ in param_shapes(cfg["model"])}


def power_limit() -> Optional[str]:
    """nvidia-smi's name and power limit of the card, or None."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and \
        r.stdout.strip() else None
