"""The plain RetinaFace with a ResNet-50 backbone: its forward pass as
functions of a state dict, in float32, written from biubug6's
Pytorch_Retinaface (``data/config.py`` ``cfg_re50``;
``models/retinaface.py``, ``models/net.py`` ``FPN`` and ``SSH``;
torchvision's ``resnet50``; ``layers/functions/prior_box.py``,
``utils/box_utils.py`` ``decode`` and ``decode_landm``; ``detect.py``)
with the configuration file's ``model`` group for its sizes, and the
state dict under the published checkpoint's names (the ``module.``
prefix stripped).

  * input: raw BGR minus (104, 117, 123);
  * backbone: a 7x7/2 conv, BN, ReLU, a 3x3/2 max pool (padding 1), then
    Bottlenecks (1x1 conv, BN, ReLU; 3x3 conv with the stage's stride,
    BN, ReLU; 1x1 conv, BN; the shortcut, a strided 1x1 conv and BN on a
    stage's first block, added; ReLU); stages 2-4 feed the FPN;
  * FPN: 1x1 conv, BN, ReLU laterals (the "LeakyReLU" of slope 0 at 256
    channels); the coarser output nearest-upsampled to the finer one's
    size and added; a 3x3 conv, BN, ReLU merge on the two finer levels;
  * SSH a level: cat(3x3 conv+BN to half the channels; 3x3 conv+BN+ReLU
    to a quarter, then 3x3 conv+BN; from that quarter 3x3 conv+BN+ReLU,
    then 3x3 conv+BN), then ReLU;
  * heads: 1x1 convs with a bias, class (2 an anchor), box (4), landmarks
    (10), each permuted NHWC and flattened location-major, anchor-minor,
    level by level;
  * priors [cx, cy, m, m] in pixels; box centre = prior centre + loc[:2]
    * v0 * m, size = m * exp(loc[2:] * v1), x1 = cx - w / 2 and x2 = x1 +
    w; keypoints = prior centre + ldm * v0 * m; score softmax(conf)[1].

Departures from the source, each also the port's: the priors, boxes and
keypoints in pixels rather than in the image's unit square (the source
scales them to pixels after the decode); a candidate is a score at or
above the confidence threshold, where ``detect.py`` keeps those above it;
the top ``top_k`` candidates by score (ties to the lower prior index, a
stable sort) go to a greedy NMS whose areas have no +1 (mmcv's IoU, the
port's NMS; ``py_cpu_nms`` adds 1 to each side); the image is the cell's
640x640 letterbox canvas rather than the image at its own size.

``precision="fp8"`` is the benchmark's control, the step below bf16:
every conv's input and weight rounded to float8 e4m3 with a per-tensor
scale. ``"f32"`` is the reference itself, with TF32 off. Nothing here
reads the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import model
from .detect import NEAR, greedy_nms
from .model import _bn_shapes, full_f32


# -- the parameters ---------------------------------------------------------

def _conv_shapes(prefix: str, cin: int, cout: int, k: int, bias: bool):
    out = [(f"{prefix}.weight", (cout, cin, k, k))]
    return out + [(f"{prefix}.bias", (cout,))] if bias else out


def _cb_shapes(prefix: str, cin: int, cout: int, k: int):
    """net.py's conv_bn and its kin: ``.0`` the conv, ``.1`` its BN."""
    return _conv_shapes(prefix + ".0", cin, cout, k, False) + \
        _bn_shapes(prefix + ".1", cout)


HEADS = (("ClassHead", 2), ("BboxHead", 4), ("LandmarkHead", None))


def param_shapes(m: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every tensor of the model, under the published
    checkpoint's names (BN running statistics included)."""
    c = m["stem_channels"]
    out = _conv_shapes("body.conv1", 3, c, 7, False) + _bn_shapes(
        "body.bn1", c)
    cin, widths = c, []
    for s, (n, planes) in enumerate(zip(m["stage_blocks"],
                                        m["stage_planes"])):
        cout = planes * m["expansion"]
        for j in range(n):
            p = f"body.layer{s + 1}.{j}"
            for i, (a, b, k) in enumerate(((cin, planes, 1),
                                           (planes, planes, 3),
                                           (planes, cout, 1))):
                out += _conv_shapes(f"{p}.conv{i + 1}", a, b, k, False)
                out += _bn_shapes(f"{p}.bn{i + 1}", b)
            if j == 0:
                out += _cb_shapes(f"{p}.downsample", cin, cout, 1)
            cin = cout
        widths.append(cout)
    widths = widths[m["neck_start_level"]:]
    o = m["out_channel"]
    for i, w in enumerate(widths):
        out += _cb_shapes(f"fpn.output{i + 1}", w, o, 1)
    for i in range(len(widths) - 1):
        out += _cb_shapes(f"fpn.merge{i + 1}", o, o, 3)
    for i in range(len(widths)):
        p = f"ssh{i + 1}"
        out += _cb_shapes(f"{p}.conv3X3", o, o // 2, 3)
        out += _cb_shapes(f"{p}.conv5X5_1", o, o // 4, 3)
        for name in ("conv5X5_2", "conv7X7_2", "conv7x7_3"):
            out += _cb_shapes(f"{p}.{name}", o // 4, o // 4, 3)
    a = m["num_anchors"]
    for name, per in HEADS:
        per = per or 2 * m["kps_num"]
        for i in range(len(widths)):
            out += _conv_shapes(f"{name}.{i}.conv1x1", o, a * per, 1, True)
    return out


# -- the forward pass ---------------------------------------------------------

class Forward(model.Forward):
    """One forward pass over a state dict, BN with its running statistics
    (YuNet's ``bn``, its precisions)."""

    def conv(self, x, name, stride=1):
        """A conv with its bias where it has one, padding k // 2."""
        w = self.sd[name + ".weight"]
        return F.conv2d(self.q(x), self.q(w), self.sd.get(name + ".bias"),
                        stride=stride, padding=w.shape[-1] // 2)

    def cb(self, x, name, relu, stride=1):
        """net.py's conv_bn (relu) or conv_bn_no_relu."""
        y = self.bn(self.conv(x, name + ".0", stride), name + ".1")
        return F.relu(y) if relu else y

    def block(self, x, p, stride):
        y = F.relu(self.bn(self.conv(x, p + ".conv1"), p + ".bn1"))
        y = F.relu(self.bn(self.conv(y, p + ".conv2", stride), p + ".bn2"))
        y = self.bn(self.conv(y, p + ".conv3"), p + ".bn3")
        if p + ".downsample.0.weight" in self.sd:
            x = self.cb(x, p + ".downsample", False, stride)
        return F.relu(y + x)

    def ssh(self, x, p):
        a = self.cb(x, p + ".conv3X3", False)
        t = self.cb(x, p + ".conv5X5_1", True)
        b = self.cb(t, p + ".conv5X5_2", False)
        c = self.cb(self.cb(t, p + ".conv7X7_2", True), p + ".conv7x7_3",
                    False)
        return F.relu(torch.cat([a, b, c], 1))

    def __call__(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x (B, 3, H, W) f32 raw BGR -> {cls, bbox, kps: (B, P, C)} in
        the priors' order: two class logits, four box offsets and ten
        landmark offsets an anchor."""
        m = self.m
        x = x - torch.tensor(m["input_mean"], dtype=x.dtype,
                             device=x.device)[:, None, None]
        x = F.relu(self.bn(self.conv(x, "body.conv1", 2), "body.bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for s, n in enumerate(m["stage_blocks"]):
            for j in range(n):
                x = self.block(x, f"body.layer{s + 1}.{j}",
                               2 if s > 0 and j == 0 else 1)
            feats.append(x)
        feats = feats[m["neck_start_level"]:]
        outs = [self.cb(f, f"fpn.output{i + 1}", True)
                for i, f in enumerate(feats)]
        for i in range(len(outs) - 2, -1, -1):
            up = F.interpolate(outs[i + 1], size=outs[i].shape[2:],
                               mode="nearest")
            outs[i] = self.cb(outs[i] + up, f"fpn.merge{i + 1}", True)
        outs = [self.ssh(f, f"ssh{i + 1}") for i, f in enumerate(outs)]
        res = {}
        for (name, per), key in zip(HEADS, ("cls", "bbox", "kps")):
            per = per or 2 * m["kps_num"]
            res[key] = torch.cat([
                self.conv(f, f"{name}.{i}.conv1x1").permute(0, 2, 3, 1)
                .reshape(f.shape[0], -1, per) for i, f in enumerate(outs)],
                dim=1)
        return res


def priors(m: dict, h: int, w: int, device) -> torch.Tensor:
    """(P, 4) [cx, cy, m, m] in pixels, location-major, anchor-minor,
    level by level (``PriorBox.forward`` before its division by the
    image's size)."""
    rows = []
    for s, sizes in zip(m["steps"], m["min_sizes"]):
        for i in range(-(-h // s)):
            for j in range(-(-w // s)):
                for size in sizes:
                    rows.append([(j + 0.5) * s, (i + 0.5) * s, size, size])
    return torch.tensor(rows, dtype=torch.float32, device=device)


def decode(pri: torch.Tensor, loc: torch.Tensor, ldm: torch.Tensor,
           variance) -> Tuple[torch.Tensor, torch.Tensor]:
    """box_utils.py's decode and decode_landm, in pixels."""
    v0, v1 = variance
    boxes = torch.cat((pri[..., :2] + loc[..., :2] * v0 * pri[..., 2:],
                       pri[..., 2:] * torch.exp(loc[..., 2:] * v1)), -1)
    lt = boxes[..., :2] - boxes[..., 2:] / 2
    boxes = torch.cat((lt, lt + boxes[..., 2:]), -1)
    pts = torch.cat([pri[..., :2] + ldm[..., 2 * i:2 * i + 2] * v0
                     * pri[..., 2:] for i in range(ldm.shape[-1] // 2)], -1)
    return boxes, pts


def detect_frames(m: dict, test: dict, sd: Dict[str, torch.Tensor],
                  frames: np.ndarray, *, top_k: int, device,
                  precision: str = "f32", block: int = 8) -> List[dict]:
    """frames (N, H, W, 3) uint8 BGR, each its own canvas -> one dict a
    frame, as ``detect.detect_frames`` gives: bboxes (n, 5), kps (n, 2K),
    the candidates (``candidates_geom``, ``candidates_score``) and the
    near set (``near_geom``, ``near_score``). NMS at ``nms_iou_thr``, the
    first ``max_per_img`` kept where it is positive (``keep_top_k``); the
    candidates then end at the last kept one's rank, since a candidate
    below it is cut whether NMS would keep it or not."""
    h, w = frames.shape[1:3]
    pri = priors(m, h, w, device)
    cap = test["max_per_img"]
    out = []
    with torch.no_grad(), full_f32():
        for s in range(0, len(frames), block):
            x = torch.from_numpy(frames[s:s + block]).to(device).float()
            flat = Forward(m, sd, precision=precision)(
                x.permute(0, 3, 1, 2))
            scores = torch.softmax(flat["cls"], -1)[..., 1]
            boxes, kps = decode(pri, flat["bbox"], flat["kps"],
                                m["variance"])
            for i in range(x.shape[0]):
                sc = scores[i].cpu().numpy()
                geom = np.concatenate([boxes[i].cpu().numpy(),
                                       kps[i].cpu().numpy()], 1)
                near = np.flatnonzero(sc >= NEAR * test["score_thr"])
                cand = np.flatnonzero(sc >= test["score_thr"])
                cand = cand[np.argsort(-sc[cand], kind="stable")][:top_k]
                keep = greedy_nms(geom[cand, :4], test["nms_iou_thr"])
                if 0 < cap < len(keep):
                    keep = keep[:cap]
                    cand = cand[:keep[-1] + 1]
                kept = cand[keep]
                out.append({
                    "bboxes": np.concatenate(
                        [geom[kept, :4], sc[kept, None]], 1),
                    "kps": geom[kept, 4:],
                    "candidates_geom": geom[cand],
                    "candidates_score": sc[cand],
                    "near_geom": geom[near], "near_score": sc[near]})
    return out
