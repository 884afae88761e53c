"""The export and import layer: yunet_tpu_torch.export == yunet_tpu.export
on the same parameters — the r04 EMA params (yunet_n) and seeded random
trees (yunet_n and yunet_s, which has no shared head convs) with BN
statistics away from the identity, on the CPU.

  * the BN fold bit-equal to the JAX package's numpy fold;
  * ONNX files byte-identical (static 160^2 and dynamic); the C++ file
    equal as a string; TFLite flatbuffers byte-identical and within
    rtol 1e-3 / atol 1e-4 of the port's model through run_tflite;
  * load_onnx_params equal to fold_inference_params (torch.equal) and,
    reshaped, to JAX's import, in both head orders;
  * the torch run_graph within rtol 1e-4 / atol 1e-5 of JAX's and within
    rtol 1e-3 / atol 1e-5 of the port's model;
  * Detector(folded=...) against JAX's, detect and detect_batch, host and
    device NMS, within test_torch_detect.py's tolerances;
  * count_macs / count_params equal to JAX's.
"""

import os

import numpy as np
import pytest
import torch

from yunet_tpu import config as jcfg
from yunet_tpu.eval.detect import Detector as JaxDetector
from yunet_tpu.export import cpp_export as jax_cpp
from yunet_tpu.export import export_onnx as jax_export_onnx
from yunet_tpu.export.onnx_import import load_onnx_params as jax_import
from yunet_tpu.export.onnx_runtime import run_graph as jax_run_graph
from yunet_tpu.models import YuNet as JaxYuNet
from yunet_tpu.utils import flops as jax_flops
from yunet_tpu_torch import config as tcfg
from yunet_tpu_torch.eval.detect import Detector
from yunet_tpu_torch.export import (export_onnx, fold_conv_bn, generate_cpp,
                                    read_onnx)
from yunet_tpu_torch.export import proto
from yunet_tpu_torch.export.cpp_export import walk_modules
from yunet_tpu_torch.export.onnx_import import load_onnx_params
from yunet_tpu_torch.export.onnx_runtime import OnnxExecutor, run_graph
from yunet_tpu_torch.models.detector import YuNet
from yunet_tpu_torch.models.fused import FoldedUnit, fold_inference_params
from yunet_tpu_torch.tools.yunet2onnx import flat_outputs
from yunet_tpu_torch.utils import flops
from yunet_tpu_torch.utils.jax_params import (jax_skeleton, load_flat_npz,
                                              state_dict_from_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "r04_ema.npz")
CASES = ["yunet_n-r04", "yunet_n-seed", "yunet_s-seed"]
CPU = torch.device("cpu")


def _seeded(cfg, seed):
    """jax_skeleton's tree filled from a numpy seed: conv weights normal
    with variance 1 / fan-in, the stem's 128 times smaller still (the
    model eats raw 0-255 pixels), so activations stay at the r04 weights'
    scale; biases, BN shifts and means normal * 0.3, BN scales in
    [0.5, 1.5], running variances in [0.2, 2]."""
    rng = np.random.RandomState(seed)

    def fill(tree, path=()):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out[k] = fill(v, path + (k,))
            elif k == "var":
                out[k] = rng.uniform(0.2, 2.0, v.shape).astype(np.float32)
            elif k == "scale":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "w":
                stem = 128.0 if path[-2:] == ("model0", "conv1") else 1.0
                out[k] = (rng.randn(*v.shape) / np.sqrt(np.prod(
                    v.shape[:3])) / stem).astype(np.float32)
            else:
                out[k] = (rng.randn(*v.shape) * 0.3).astype(np.float32)
        return out
    return tuple(fill(t) for t in jax_skeleton(cfg.model))


@pytest.fixture(scope="module", params=CASES)
def case(request):
    """(name, JAX config, params, state, the port's YuNet on the CPU)."""
    name, weights = request.param.split("-")
    cfg = getattr(jcfg, name)()
    if weights == "r04":
        params, state = load_flat_npz(FIXTURE, cfg.model)
    else:
        params, state = _seeded(cfg, 5 if name == "yunet_n" else 6)
    model = YuNet(getattr(tcfg, name)().model, device=CPU)
    model.load_state_dict(state_dict_from_jax(params, state))
    return name, cfg, params, state, model


def _write(tmp_path, name, blob):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(blob)
    return path


def test_codec_copies_equal_jax():
    """proto.py and onnx_reader.py are copies of the JAX package's."""
    for mod in ("proto.py", "onnx_reader.py"):
        with open(os.path.join(ROOT, "yunet_tpu_torch", "export", mod),
                  "rb") as a, open(os.path.join(ROOT, "yunet_tpu", "export",
                                                mod), "rb") as b:
            assert a.read() == b.read(), mod


def test_proto_round_trip():
    msg = {1: [7, 2 ** 40, -3], 2: [b"yunet", b""], 5: [proto.f32(1.5)],
           9: [(1, b"\x01" * 8)]}
    assert proto.decode_message(proto.encode_message(msg)) == {
        1: [7, 2 ** 40, 2 ** 64 - 3], 2: [b"yunet", b""],
        5: [(5, proto.f32(1.5)[1])], 9: [(1, b"\x01" * 8)]}
    for v in (0, 1, 127, 128, 300, 2 ** 63):
        assert proto.decode_varint(proto.encode_varint(v), 0)[0] == v


def test_fold_bit_equal_to_jax(case):
    """Every BN fold of the model (stem, backbone, neck, head shares) is
    bit-equal to JAX's numpy fold on HWIO weights."""
    _, cfg, params, state, model = case
    n = 0
    for (_, kind, m), (_, jkind, p, s) in zip(
            walk_modules(model, cfg.model),
            jax_cpp.walk_modules(params, state, cfg.model)):
        assert kind == jkind
        pairs = []
        if kind == "conv_head":
            pairs.append(((m.conv1, m.bn1), (p["conv1"], p["bn1"],
                                              s["bn1"])))
            units = [(m.conv2, p["conv2"], s["conv2"])]
        elif kind == "conv4layer":
            units = [(m.conv1, p["conv1"], s["conv1"]),
                     (m.conv2, p["conv2"], s["conv2"])]
        else:
            units = [(m, p, s)]
        pairs += [((u.conv2, u.bn), (up["conv2"], up["bn"], us["bn"]))
                  for u, up, us in units if u.bn is not None]
        for (conv, bn), (pc, pbn, sbn) in pairs:
            w, b = fold_conv_bn(conv.weight, conv.bias, bn)
            jw, jb = jax_cpp.fold_conv_bn(pc["w"], pc["b"], pbn, sbn)
            np.testing.assert_array_equal(
                w.numpy(), np.transpose(jw, (3, 2, 0, 1)))
            np.testing.assert_array_equal(b.numpy(), jb)
            n += 1
    # stem + 2 a stage + 3 laterals (+ 3 shares for yunet_n)
    assert n == 1 + 2 * len(cfg.model.stage_channels) - 1 + 3 + 3 * (
        cfg.model.shared_stacked_convs)


def _nodes(path):
    g = read_onnx(path)
    return [(n.op_type, n.name, n.inputs, n.outputs, n.attrs)
            for n in g.nodes], g


@pytest.mark.parametrize("dynamic", [False, True])
def test_export_onnx_bytes_equal_jax(case, dynamic, tmp_path):
    _, cfg, params, state, model = case
    ours = export_onnx(model, cfg.model, input_shape=(160, 160),
                       dynamic=dynamic)
    theirs = jax_export_onnx(params, state, cfg.model,
                             input_shape=(160, 160), dynamic=dynamic)
    # the node lists first: a shifted name counter reads plainly there
    a, ga = _nodes(_write(tmp_path, "ours.onnx", ours))
    b, gb = _nodes(_write(tmp_path, "theirs.onnx", theirs))
    assert a == b
    assert list(ga.initializers) == list(gb.initializers)
    assert ours == theirs
    assert ga.name == "yunet_tpu" and ga.outputs == [
        f"{k}_{s}" for k in ("cls", "obj", "bbox", "kps") for s in (8, 16, 32)]
    assert ga.input_shapes["input"] == (["batch", 3, "height", "width"]
                                        if dynamic else [1, 3, 160, 160])


def test_generate_cpp_equal_jax(case):
    _, cfg, params, state, model = case
    ours = generate_cpp(model, cfg.model)
    assert ours == jax_cpp.generate_cpp(params, state, cfg.model)
    assert ours.count("ConvInfoStruct param_pConvInfo") == 1


def _branch_major(blob, cfg):
    """The exported file with its head Conv nodes in the reference's
    torch-trace order (every level's shares, then cls, bbox, obj and kps
    across the levels), rewritten with the port's codec. Only the Conv
    order matters to the importer."""
    model = proto.decode_message(blob)
    graph = proto.decode_message(model[7][0])
    nodes = graph[1]
    conv_at = [i for i, n in enumerate(nodes)
               if proto.get_str(proto.decode_message(n), 4) == "Conv"]
    m = cfg.model
    first = 1 + 2 * (1 + 2 * (len(m.stage_channels) - 1) + len(m.strides))
    head = conv_at[first:]
    shares, nl = m.shared_stacked_convs, len(m.strides)
    per_level = shares + 4
    pairs = [(head[2 * k], head[2 * k + 1]) for k in range(len(head) // 2)]
    order = [lvl * per_level + j for lvl in range(nl) for j in range(shares)]
    order += [lvl * per_level + shares + b for b in range(4)
              for lvl in range(nl)]
    new = list(nodes)
    for slot, src in zip(pairs, order):
        for i, j in zip(slot, pairs[src]):
            new[i] = nodes[j]
    graph[1] = new
    model[7] = [proto.encode_message(graph)]
    return proto.encode_message(model)


def _check_folded_equal(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _check_folded_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _check_folded_equal(a, b)
    elif isinstance(want, FoldedUnit):
        for f in ("w1", "b1", "wd", "bd"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.is_contiguous() and a.dtype == torch.float32
            assert torch.equal(a, b), f
        assert got.relu == want.relu
    else:
        assert torch.equal(got, want)


def _check_equal_to_jax(got, want):
    """The port's tree against JAX's: FoldedUnits against JAX's HWIO
    units (w1 (1, 1, Cin, Cout), wd (3, 3, 1, Cout)), the stem OIHW
    against HWIO; JAX's import keeps an empty share list with no shares."""
    if isinstance(got, FoldedUnit):
        np.testing.assert_array_equal(got.w1.numpy(), want["w1"][0, 0])
        np.testing.assert_array_equal(got.wd.numpy(),
                                      want["wd"].reshape(9, -1))
        np.testing.assert_array_equal(got.b1.numpy(), want["b1"])
        np.testing.assert_array_equal(got.bd.numpy(), want["bd"])
        assert got.relu == want["relu"]
    elif isinstance(got, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _check_equal_to_jax(a, b)
    elif "w" in got:
        np.testing.assert_array_equal(got["w"].numpy(),
                                      np.transpose(want["w"], (3, 2, 0, 1)))
        np.testing.assert_array_equal(got["b"].numpy(), want["b"])
    else:
        assert set(got) == set(want) - ({"share"} if want.get("share") == []
                                         else set())
        for k in got:
            _check_equal_to_jax(got[k], want[k])


@pytest.mark.parametrize("order", ["per_level", "branch_major"])
def test_load_onnx_params_equal_fold_and_jax(case, order, tmp_path):
    _, cfg, params, state, model = case
    blob = export_onnx(model, cfg.model, input_shape=(160, 160))
    if order == "branch_major":
        blob = _branch_major(blob, cfg)
        assert blob != export_onnx(model, cfg.model, input_shape=(160, 160))
    path = _write(tmp_path, "m.onnx", blob)
    got = load_onnx_params(path, cfg.model, device=CPU)
    _check_folded_equal(got, fold_inference_params(model, cfg.model))
    _check_equal_to_jax(got, jax_import(path, cfg.model))


def test_load_onnx_params_rejects_unknown_head(tmp_path):
    """A file whose head matches neither order raises: yunet_n's file read
    with yunet_s's plan (no shared convs)."""
    cfg = tcfg.yunet_n()
    model = YuNet(cfg.model, device=CPU)
    path = _write(tmp_path, "m.onnx", export_onnx(model, cfg.model,
                                                  input_shape=(64, 64)))
    with pytest.raises(ValueError, match="unrecognized head"):
        load_onnx_params(path, tcfg.yunet_s().model, device=CPU)


@pytest.mark.parametrize("dynamic", [False, True])
def test_run_graph_matches_jax_and_model(case, dynamic, tmp_path):
    _, cfg, params, state, model = case
    path = _write(tmp_path, "m.onnx", export_onnx(
        model, cfg.model, input_shape=(160, 160), dynamic=dynamic))
    g = read_onnx(path)
    rng = np.random.RandomState(1)
    shapes = [(2, 96, 128), (1, 160, 160)] if dynamic else [(1, 160, 160)]
    ex = OnnxExecutor(path, device=CPU)
    for b, h, w in shapes:
        img = rng.randint(0, 256, (b, 3, h, w)).astype(np.float32)
        got = run_graph(g, {"input": torch.from_numpy(img)})
        want_jax = jax_run_graph(g, {"input": img})
        want = flat_outputs(model, img)
        via_executor = ex(img)
        assert set(got) == set(want) == set(want_jax)
        for k in want:
            assert got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k].numpy(),
                                       np.asarray(want_jax[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{k} vs jax")
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-3,
                                       atol=1e-5, err_msg=f"{k} vs model")
            np.testing.assert_array_equal(via_executor[k], got[k].numpy())


def test_run_graph_torch_shape_subgraph():
    """The shape ops of a dynamic torch export (Shape, Gather with a 0-d
    index, Unsqueeze, Concat, Reshape copying dimension 0) on host
    values, and Gather/Concat/Identity on device tensors, against JAX's
    run_graph."""
    from yunet_tpu_torch.export.onnx_reader import OnnxGraph, OnnxNode

    def node(op, ins, outs, **attrs):
        return OnnxNode(op, outs[0], ins, outs, attrs)
    g = OnnxGraph(name="shape", nodes=[
        node("Shape", ["x"], ["s"]),
        node("Gather", ["s", "zero"], ["b"], axis=0),
        node("Unsqueeze", ["b"], ["b1"], axes=[0]),
        node("Concat", ["b1", "tail"], ["shape"], axis=0),
        node("Transpose", ["x"], ["t"], perm=[0, 2, 3, 1]),
        node("Reshape", ["t", "shape"], ["r"]),
        node("Reshape", ["t", "keep0"], ["r0"]),
        node("Gather", ["r", "idx"], ["gx"], axis=1),
        node("Concat", ["gx", "gx"], ["cx"], axis=2),
        node("Identity", ["cx"], ["out"]),
        node("Add", ["r0", "r0"], ["out0"])],
        initializers={"zero": np.asarray(0, np.int64),
                      "tail": np.asarray([-1, 3], np.int64),
                      "keep0": np.asarray([0, -1, 3], np.int64),
                      "idx": np.asarray([2, 0], np.int64)},
        inputs=["x"], outputs=["out", "out0", "shape"])
    x = np.random.RandomState(0).randn(2, 3, 4, 5).astype(np.float32)
    got = run_graph(g, {"x": torch.from_numpy(x)})
    want = jax_run_graph(g, {"x": x})
    assert isinstance(got["shape"], np.ndarray)
    for k in g.outputs:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.fixture(scope="module")
def folded_detectors(tmp_path_factory):
    """(JAX Detector(folded=...) f32, the port's Detector(None, folded=...)
    f32 on the CPU, the port's Detector(fused=True) from the model), from
    one export of the r04 params."""
    cfg = jcfg.yunet_n()
    params, state = load_flat_npz(FIXTURE, cfg.model)
    model = YuNet(tcfg.yunet_n().model, device=CPU)
    model.load_state_dict(state_dict_from_jax(params, state))
    path = _write(tmp_path_factory.mktemp("onnx"), "r04.onnx",
                  export_onnx(model, cfg.model, input_shape=(64, 96)))
    jdet = JaxDetector(cfg, folded=jax_import(path, cfg.model), bf16=False)
    tdet = Detector(tcfg.yunet_n(), None, device=CPU, dtype=torch.float32,
                    folded=load_onnx_params(path, cfg.model, device=CPU))
    fdet = Detector(tcfg.yunet_n(), model, device=CPU, dtype=torch.float32,
                    fused=True)
    return jdet, tdet, fdet, path


def _img(h, w, seed):
    return np.random.RandomState(seed).randint(
        0, 256, (h, w, 3)).astype(np.uint8)


def _same(got, want):
    assert got["bboxes"].shape == want["bboxes"].shape
    np.testing.assert_allclose(got["bboxes"], want["bboxes"], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got["kps"], want["kps"], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_array_equal(got["labels"], want["labels"])


def _equal(got, want):
    for k in ("bboxes", "kps", "labels"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("use_device_nms", [False, True])
def test_folded_detector_matches_jax(folded_detectors, use_device_nms):
    """detect and detect_batch of the imported Detector against JAX's
    imported Detector, and equal to the port's fused Detector built from
    the model (the same folded weights)."""
    jdet, tdet, fdet, _ = folded_detectors
    assert tdet.model is None
    img = _img(64, 96, 11)
    want = jdet.detect(img, use_device_nms=use_device_nms)
    got = tdet.detect(img, use_device_nms=use_device_nms)
    assert want["bboxes"].shape[0] > 0
    _same(got, want)
    _equal(got, fdet.detect(img, use_device_nms=use_device_nms))
    imgs = [_img(64, 96, 12), _img(50, 70, 13)]
    want = jdet.detect_batch(imgs, "AUTO", use_device_nms=use_device_nms)
    got = tdet.detect_batch(imgs, "AUTO", use_device_nms=use_device_nms)
    mine = fdet.detect_batch(imgs, "AUTO", use_device_nms=use_device_nms)
    assert len(got) == len(want) == 2
    for g, w, f in zip(got, want, mine):
        _same(g, w)
        _equal(g, f)


def test_folded_detector_sweep_and_warmup(folded_detectors):
    """A Detector with no model runs the sweep (with a solo image whose
    size hint is stale) and warmup."""
    _, tdet, fdet, _ = folded_detectors
    imgs = [_img(64, 96, 20), _img(64, 96, 21), _img(40, 60, 22)]
    entries = [(lambda im=im: im, im.shape[:2]) for im in imgs]
    entries[2] = (entries[2][0], (64, 96))           # stale hint
    got = tdet.detect_sweep(entries, "AUTO", batch_size=2)
    want = fdet.detect_sweep(entries, "AUTO", batch_size=2)
    assert tdet.last_sweep_stats["misfit_solo"] == 1
    for g, w in zip(got, want):
        _equal(g, w)
    tdet.warmup([(64, 96)])


def test_init_detector_from_onnx(folded_detectors):
    from yunet_tpu_torch.apis import init_detector
    _, _, fdet, path = folded_detectors
    det = init_detector("yunet_n", path, device="cpu", dtype=torch.float32)
    assert det.model is None and det.folded is not None
    img = _img(64, 96, 11)
    _equal(det.detect(img), fdet.detect(img))


def test_detector_needs_one_source():
    cfg = tcfg.yunet_n()
    with pytest.raises(ValueError):
        Detector(cfg, device=CPU)
    model = YuNet(cfg.model, device=CPU)
    with pytest.raises(ValueError):
        Detector(cfg, model, device=CPU,
                 folded=fold_inference_params(model, cfg.model))


@pytest.mark.parametrize("name", ["yunet_n", "yunet_s"])
def test_count_macs_equal_jax(name):
    cfg = getattr(jcfg, name)().model
    for shape in ((320, 320), (640, 640), (256, 320)):
        assert flops.count_macs(cfg, shape) == jax_flops.count_macs(cfg,
                                                                    shape)
    assert flops.count_params(cfg) == JaxYuNet(cfg).num_params


@pytest.mark.parametrize("quantize", ["none", "dynamic"])
def test_tflite_export_equal_jax_and_model(quantize):
    """export_tflite: the flatbuffer byte-identical to JAX's, and run
    through run_tflite within rtol 1e-3 / atol 1e-4 of the port's model
    (float) at 96x128, the JAX test's gate."""
    pytest.importorskip("tensorflow")
    from yunet_tpu.export.tflite_export import export_tflite as jax_tflite
    from yunet_tpu_torch.export.tflite_export import (export_tflite,
                                                      run_tflite)
    cfg = jcfg.yunet_n()
    params, state = load_flat_npz(FIXTURE, cfg.model)
    model = YuNet(tcfg.yunet_n().model, device=CPU)
    model.load_state_dict(state_dict_from_jax(params, state))
    blob = export_tflite(model, cfg.model, input_shape=(96, 128),
                         quantize=quantize)
    assert blob == jax_tflite(params, state, cfg.model,
                              input_shape=(96, 128), quantize=quantize)
    if quantize != "none":
        return
    img = np.random.RandomState(0).randint(
        0, 256, (1, 3, 96, 128)).astype(np.float32)
    got = run_tflite(blob, img)
    want = flat_outputs(model, img)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4,
                                   err_msg=k)

