"""ONNX executor: run YuNet-class ONNX graphs with PyTorch library ops —
counterpart of ``yunet_tpu/export/onnx_runtime.py``.

The reference deploys with ONNXRuntime (tools/compare_inference.py). Here
each node of the (small) supported op set runs eagerly as a torch op on
the feed's device, so an .onnx file executes on the card as the file
itself, with no model code: a check of the deployed artifact and a
yardstick for the native program.

Supported ops: Conv (grouped), Relu, Sigmoid, MaxPool(2x2/2),
Resize(nearest 2x), Add, Transpose, Reshape, Identity, Concat, plus the
shape-computation subgraphs torch emits for dynamic-axes exports
(Shape, Gather, Unsqueeze — reference onnx/yunet_n_dynamic.onnx). Shapes
stay host values (numpy), as the JAX executor keeps them, so a Reshape's
target is known on the host and never waits on the device.

f32 convolutions on the card run in TF32 unless the caller turns it off
(``torch.backends.cudnn.allow_tf32 = False``); the executor sets no global
flag.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .onnx_reader import OnnxGraph, read_onnx

_HOST = (np.ndarray, np.generic)


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def run_graph(g: OnnxGraph, feeds: Dict[str, torch.Tensor], *,
              consts: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, torch.Tensor]:
    """Execute the graph on the device of ``feeds`` (torch tensors).

    consts: a dict that keeps the float initializers once moved to the
    device, across calls (OnnxExecutor passes its own); None moves them
    on this call only."""
    device = next(iter(feeds.values())).device
    consts = {} if consts is None else consts
    env = dict(g.initializers)
    env.update(feeds)

    def dev(name: str, dtype=None) -> torch.Tensor:
        """The value ``name`` as a tensor on the device."""
        v = env[name]
        if not isinstance(v, torch.Tensor):
            if name not in consts:
                consts[name] = torch.from_numpy(np.array(v, order="C")).to(
                    device)
            v = consts[name]
        return v if dtype is None else v.to(dtype)

    for node in g.nodes:
        names = [i for i in node.inputs if i != ""]
        ins = [env[i] for i in names]
        op = node.op_type
        if op == "Conv":
            x = dev(names[0])
            w = dev(names[1], x.dtype)
            b = dev(names[2], x.dtype) if len(names) > 2 else None
            pads = node.attrs.get("pads", [0, 0, 0, 0])
            if pads[0] != pads[2] or pads[1] != pads[3]:
                x = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
                pads = [0, 0, 0, 0]
            out = F.conv2d(x, w, b, stride=tuple(node.attrs.get(
                "strides", [1, 1])), padding=(pads[0], pads[1]),
                groups=node.attrs.get("group", 1))
        elif op == "Relu":
            out = torch.relu(dev(names[0]))
        elif op == "Sigmoid":
            out = torch.sigmoid(dev(names[0]))
        elif op == "MaxPool":
            out = F.max_pool2d(dev(names[0]), 2, 2)
        elif op == "Resize":
            scales = _host(ins[-1])
            if list(scales[2:]) != [2.0, 2.0]:
                raise NotImplementedError(f"Resize by {scales}: only the "
                                          "nearest 2x upsample")
            out = dev(names[0]).repeat_interleave(2, dim=2) \
                .repeat_interleave(2, dim=3)
        elif op == "Add":
            out = (ins[0] + ins[1] if all(isinstance(v, _HOST) for v in ins)
                   else dev(names[0]) + dev(names[1]))
        elif op == "Transpose":
            out = dev(names[0]).permute(*node.attrs["perm"])
        elif op == "Reshape":
            shape = [int(v) for v in _host(ins[1])]
            x = dev(names[0])
            shape = [x.shape[i] if v == 0 else v
                     for i, v in enumerate(shape)]
            out = x.reshape(shape)
        elif op == "Identity":
            out = ins[0]
        elif op == "Shape":
            out = np.asarray(ins[0].shape, np.int64)
        elif op == "Gather":
            # shape gathers stay on the host, so Reshape targets are host
            # values
            axis = node.attrs.get("axis", 0)
            data, idx = ins[0], _host(ins[1])
            if isinstance(data, _HOST):
                out = np.take(data, idx, axis=axis)
            else:
                t = torch.from_numpy(np.asarray(idx, np.int64)).to(device)
                picked = dev(names[0]).index_select(axis, t.reshape(-1))
                out = picked.reshape(data.shape[:axis] + tuple(idx.shape)
                                     + data.shape[axis + 1:])
        elif op == "Unsqueeze":
            out = ins[0]
            for ax in sorted(node.attrs["axes"]):
                out = (np.expand_dims(out, ax) if isinstance(out, _HOST)
                       else out.unsqueeze(ax))
        elif op == "Concat":
            axis = node.attrs.get("axis", 0)
            out = (np.concatenate(ins, axis=axis)
                   if all(isinstance(v, _HOST) for v in ins)
                   else torch.cat([dev(n) for n in names], dim=axis))
        else:
            raise NotImplementedError(f"onnx op {op}")
        env[node.outputs[0]] = out
    return {o: env[o] for o in g.outputs}


class OnnxExecutor:
    """An ONNX file run by ``run_graph`` on ``device``; the initializers
    move to the device once, on the first call."""

    def __init__(self, path: str, *, device):
        self.graph = read_onnx(path)
        self.device = torch.device(device)
        self._consts: Dict[str, torch.Tensor] = {}

    @property
    def input_shape(self):
        return self.graph.input_shapes[self.graph.inputs[0]]

    def run(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: (B, 3, H, W) f32 NCHW on the device -> the named outputs as
        device tensors."""
        return run_graph(self.graph, {self.graph.inputs[0]: x},
                         consts=self._consts)

    def __call__(self, x) -> Dict[str, np.ndarray]:
        """x: (B, 3, H, W) float32 NCHW (the ONNX contract), numpy or a
        tensor -> the named outputs as numpy arrays."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return {k: _host(v) for k, v in self.run(x).items()}
