"""How ``Detector.detect(use_device_nms=True)`` runs its batch-1 device
program (``Detector.detect_packed``): eagerly, or as a CUDA graph.

The rule (``Graphs.key``): on a CUDA device with a folded tree, a graph
for each canvas shape, input dtype, trunk dtype and top-k. A key's first
call runs eagerly (loading kernels and lazy caches), its second captures
and runs the graph, later calls replay it: the same kernels in the same
order, so the same bits. ``GRAPHS_KEPT`` keys stay primed and as many
graphs, the least recently used evicted first.

Each graph owns a stage, pinned host tensors of its eager call's input
and output. A call copies the canvas into it (an f32 trunk's cast in the
same pass); the graph copies that in first and its rows out last; the
call synchronizes the stream, then reads the stage.

A capture freezes the kernels the module functions in use then launch
(say ``models.fused.fused_conv_dp``): to run another function, run
eagerly (``Graphs.key`` returning None). The wrappers' launch counters
count what their Python issues, eagerly or into a capture, not a replay.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.profiling import span

GRAPH_DEVICE = "cuda"
GRAPHS_KEPT = 4

# run: stage.x -> the static x, the program -> packed -> stage.packed
Graph = collections.namedtuple("Graph", ("run", "x", "packed", "stage"))
Stage = collections.namedtuple("Stage", ("x", "packed"))


def _keep(lru: collections.OrderedDict, key, value) -> None:
    lru[key] = value
    if len(lru) > GRAPHS_KEPT:
        lru.popitem(last=False)


class Graphs:
    """One Detector's graphs (holding nothing of it). ``primed``: key ->
    its eager call's (shape, dtype) in and out; ``kept``: key -> Graph."""

    def __init__(self, device: torch.device, dtype: torch.dtype,
                 folded: bool):
        self.device, self.dtype, self.folded = device, dtype, folded
        self.primed = collections.OrderedDict()
        self.kept = collections.OrderedDict()
        self.captures = self.replays = 0

    def key(self, det_img: np.ndarray, top_k: int) -> Optional[tuple]:
        """The canvas's key, or None where the program is not graphed."""
        if self.device.type != GRAPH_DEVICE or not self.folded:
            return None
        return (det_img.shape, det_img.dtype, self.dtype, top_k)

    def record(self, stage: Stage, top_k: int, program: Callable):
        """Capture (runs nothing) -> (replay, static input, output)."""
        x = torch.empty_like(stage.x, device=self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            x.copy_(stage.x, non_blocking=True)
            packed = program(x, top_k)
            stage.packed.copy_(packed, non_blocking=True)
        return graph.replay, x, packed

    def run(self, det_img: np.ndarray, top_k: int, lap, upload: Callable,
            program: Callable) -> np.ndarray:
        """One canvas -> ``program``'s rows on the host (a view of the stage
        after a graph's run); ``upload`` (canvases -> x) feeds an eager
        call, ``lap`` closes ``put`` and ``dispatch``."""
        key = self.key(det_img, top_k)
        graph = self.kept.get(key)
        if graph is None and key not in self.primed:
            x = upload([det_img])
            lap("put")
            packed = program(x, top_k)
            if key is not None:
                _keep(self.primed, key, ((x.shape, x.dtype),
                                         (packed.shape, packed.dtype)))
            lap("dispatch")
            with span("yunet.readback"):
                return packed.cpu().numpy()
        on_card = self.device.type == GRAPH_DEVICE
        stage = graph.stage if graph is not None else Stage(*(
            torch.empty(shape, dtype=dtype, pin_memory=on_card)
            for shape, dtype in self.primed[key]))
        with span("yunet.upload"):
            np.copyto(stage.x.numpy(), det_img, casting="unsafe")
        lap("put")
        if graph is None:
            graph = Graph(*self.record(stage, top_k, program), stage)
            del self.primed[key]
            _keep(self.kept, key, graph)
            self.captures += 1
        else:
            self.kept.move_to_end(key)
            self.replays += 1
        with span("yunet.graph"):
            graph.run()
        lap("dispatch")
        with span("yunet.readback"):
            if on_card:
                torch.cuda.current_stream(self.device).synchronize()
            return stage.packed.numpy()
