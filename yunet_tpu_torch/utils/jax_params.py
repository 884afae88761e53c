"""Parameter bridge: JAX (params, state) numpy pytrees <-> this package's
``state_dict`` — the inverse of ``yunet_tpu/utils/torch_import.py:53-114``
— plus loaders for the flat ``.npz`` fixture and reference ``.pth`` files.

JAX trees are nested dicts (the layout ``yunet_tpu.models.YuNet.init``
returns); keys map one to one onto the reference checkpoint keys:

  params[...]["w"]  HWIO (kh, kw, I, O)  <->  ...weight  OIHW (O, I, kh, kw)
      (depthwise (3, 3, 1, C) <-> (C, 1, 3, 3) is the same transpose)
  params[...]["b"]                       <->  ...bias
  BN params {scale, bias}                <->  bn.{weight, bias}
  BN state  {mean, var}                  <->  bn.{running_mean, running_var}
  top-level "head"                       <->  "bbox_head"

No jax is needed: the JAX tree's structure is rebuilt from the config as a
numpy skeleton, and flattened as ``jax.tree_util`` flattens dicts (keys in
sorted order).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from ..config import ModelConfig

Tree = Dict[str, Any]

_PARAM_LEAF = {"w": "weight", "b": "bias", "scale": "weight",
               "bias": "bias"}
_STATE_LEAF = {"mean": "running_mean", "var": "running_var"}


# -- the JAX tree's structure ------------------------------------------------

def _conv(kh: int, kw: int, cin: int, cout: int) -> Tree:
    return {"w": np.zeros((kh, kw, cin, cout), np.float32),
            "b": np.zeros((cout,), np.float32)}


def _bn(c: int) -> Tuple[Tree, Tree]:
    z = np.zeros((c,), np.float32)
    return {"scale": z, "bias": z}, {"mean": z, "var": z}


def _unit(cin: int, cout: int, with_bn: bool) -> Tuple[Tree, Tree]:
    p: Tree = {"conv1": _conv(1, 1, cin, cout), "conv2": _conv(3, 3, 1, cout)}
    s: Tree = {}
    if with_bn:
        p["bn"], s["bn"] = _bn(cout)
    return p, s


def jax_skeleton(cfg: ModelConfig) -> Tuple[Tree, Tree]:
    """Zero-filled (params, state) with the structure and shapes of
    ``yunet_tpu.models.YuNet(cfg).init`` (models/layers.py, backbone.py,
    neck.py, head.py *_init)."""
    pb: Tree = {}
    sb: Tree = {}
    cin, cmid, cout = cfg.stage_channels[0]
    p0 = {"conv1": _conv(3, 3, cin, cmid)}
    p0["bn1"], s_bn1 = _bn(cmid)
    p0["conv2"], s_c2 = _unit(cmid, cout, True)
    pb["model0"], sb["model0"] = p0, {"bn1": s_bn1, "conv2": s_c2}
    for i, (ci, co) in enumerate(cfg.stage_channels[1:], start=1):
        p1, s1 = _unit(ci, ci, True)
        p2, s2 = _unit(ci, co, True)
        pb[f"model{i}"] = {"conv1": p1, "conv2": p2}
        sb[f"model{i}"] = {"conv1": s1, "conv2": s2}
    pn: Tree = {"lateral_convs": {}}
    sn: Tree = {"lateral_convs": {}}
    for i, c in enumerate(cfg.neck_in_channels):
        pn["lateral_convs"][str(i)], sn["lateral_convs"][str(i)] = \
            _unit(c, c, True)
    ph: Tree = {}
    sh: Tree = {}
    out_ch = {"multi_level_cls": cfg.num_classes, "multi_level_bbox": 4,
              "multi_level_obj": 1, "multi_level_kps": cfg.kps_num * 2}
    branches = list(out_ch) if cfg.use_kps else list(out_ch)[:3]
    chn = cfg.head_in_channels
    if cfg.shared_stacked_convs > 0:
        ph["multi_level_share_convs"] = {}
        sh["multi_level_share_convs"] = {}
        chn = cfg.feat_channels
    for b in branches:
        ph[b], sh[b] = {}, {}
    for lvl in range(len(cfg.strides)):
        if cfg.shared_stacked_convs > 0:
            sp, ss = {}, {}
            for i in range(cfg.shared_stacked_convs):
                ci = cfg.head_in_channels if i == 0 else cfg.feat_channels
                sp[str(i)], ss[str(i)] = _unit(ci, cfg.feat_channels, True)
            ph["multi_level_share_convs"][str(lvl)] = sp
            sh["multi_level_share_convs"][str(lvl)] = ss
        for b in branches:
            ph[b][str(lvl)], sh[b][str(lvl)] = _unit(chn, out_ch[b], False)
    return ({"backbone": pb, "neck": pn, "head": ph},
            {"backbone": sb, "neck": sn, "head": sh})


def _leaves(tree: Tree, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in jax.tree_util's dict order: keys sorted."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set_leaf(tree: Tree, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _copy_structure(tree: Tree) -> Tree:
    return {k: _copy_structure(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def _torch_key(path: Tuple[str, ...], leaf_names: Dict[str, str]) -> str:
    head, *mid, leaf = path
    return ".".join(["bbox_head" if head == "head" else head, *mid,
                     leaf_names[leaf]])


# -- conversions ---------------------------------------------------------------

def state_dict_from_jax(params: Tree, state: Tree) -> Dict[str, torch.Tensor]:
    """JAX (params, state) numpy trees -> a ``YuNet`` state_dict (CPU f32;
    BN ``num_batches_tracked`` set to 0)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        a = np.asarray(leaf, np.float32)
        if path[-1] == "w":
            a = a.transpose(3, 2, 0, 1)                 # HWIO -> OIHW
        sd[_torch_key(path, _PARAM_LEAF)] = torch.from_numpy(
            np.array(a, order="C"))
    for path, leaf in _leaves(state):
        key = _torch_key(path, _STATE_LEAF)
        sd[key] = torch.from_numpy(np.array(leaf, np.float32))
        if path[-1] == "mean":
            sd[key.rsplit(".", 1)[0] + ".num_batches_tracked"] = \
                torch.zeros((), dtype=torch.int64)
    return sd


def jax_from_state_dict(sd: Dict[str, torch.Tensor], cfg: ModelConfig
                        ) -> Tuple[Tree, Tree]:
    """A ``YuNet`` (or reference) state_dict -> JAX (params, state)
    numpy trees with the structure of ``jax_skeleton(cfg)``."""
    params, state = (_copy_structure(t) for t in jax_skeleton(cfg))
    for tree, names in ((params, _PARAM_LEAF), (state, _STATE_LEAF)):
        for path, leaf in list(_leaves(tree)):
            a = sd[_torch_key(path, names)].detach().cpu().float().numpy()
            if path[-1] == "w":
                a = a.transpose(2, 3, 1, 0)             # OIHW -> HWIO
            if a.shape != leaf.shape:
                raise ValueError(f"{'/'.join(path)}: shape {a.shape}, "
                                 f"expected {leaf.shape}")
            _set_leaf(tree, path, np.ascontiguousarray(a))
    return params, state


def load_flat_npz(path: str, cfg: ModelConfig) -> Tuple[Tree, Tree]:
    """Rebuild (params, state) from a flat ``.npz`` whose leaves are stored
    as ``p{i}`` / ``s{i}`` in jax.tree_util flatten order (the format of
    tests/fixtures/r04_ema.npz; tests/test_hard_band.py:87-97)."""
    params, state = (_copy_structure(t) for t in jax_skeleton(cfg))
    with np.load(path, allow_pickle=False) as blob:
        for tree, tag in ((params, "p"), (state, "s")):
            leaves: List = list(_leaves(tree))
            if f"{tag}{len(leaves)}" in blob or f"{tag}{len(leaves) - 1}" \
                    not in blob:
                raise ValueError(f"{path}: leaf count of '{tag}' does not "
                                 f"match the {cfg.name} tree "
                                 f"({len(leaves)} leaves)")
            for i, (p, leaf) in enumerate(leaves):
                a = np.asarray(blob[f"{tag}{i}"], np.float32)
                if a.shape != leaf.shape:
                    raise ValueError(f"{path}: {tag}{i} ({'/'.join(p)}) has "
                                     f"shape {a.shape}, expected "
                                     f"{leaf.shape}")
                _set_leaf(tree, p, a)
    return params, state


def load_pth_state_dict(path: str, *,
                        trusted: bool = False) -> Dict[str, torch.Tensor]:
    """The model weights of a reference ``.pth`` checkpoint.

    The file is read with ``weights_only=True`` (tensors and plain
    containers). A checkpoint whose metadata needs a full unpickle (some
    mmcv checkpoints do) raises unless ``trusted=True``: unpickling runs
    code from the file, so pass it only for a checkpoint from a trusted
    source."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if not trusted:
            raise ValueError(
                f"{path} holds objects that only a full unpickle restores; "
                "pass trusted=True if the file comes from a trusted "
                "source") from e
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v for k, v in sd.items()
            if k.split(".", 1)[0] in ("backbone", "neck", "bbox_head")}
