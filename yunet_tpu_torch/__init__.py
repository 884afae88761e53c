"""yunet_tpu_torch — the YuNet serving path and train step in PyTorch, for
NVIDIA Hopper.

A port of the JAX package ``yunet_tpu`` (which stays the numerical
reference) to PyTorch. Module names follow ``yunet_tpu`` so each module's
counterpart is easy to find. The package imports ``torch`` and never
``jax`` or ``yunet_tpu``.

Layout:
  config.py        dataclass presets (a copy of yunet_tpu.config)
  models/          ConvDPUnit / backbone / TFPN neck / head / detector as
                   nn.Modules named like the reference checkpoint keys
                   (train mode: JAX's BatchNorm algebra, GhostBN);
                   fused.py folds BN and runs the fused-unit forward
  ops/             priors, boxes, losses, SimOTA assignment; fused
                   ConvDPUnit (forward, trainable backward, channels-major
                   variant), greedy NMS and streamed SimOTA (each a
                   hand-written CUDA kernel beside its plain PyTorch
                   version); the nvcc build helper
  train/           targets, LR schedule, EMA, SGD and the train step
  csrc/            the CUDA sources and the host NMS source, built at
                   first use into _build/
  utils/           JAX-pytree / .npz / .pth parameter bridge
  eval/detect.py   Detector: preprocess -> forward -> decode -> NMS
  native.py        exact host greedy NMS (csrc/host_nms.cpp, a copy of
                   the JAX package's C++ source)
  apis.py          init_detector / inference_detector
  tools/           bench_convdp_cm (channels-major ConvDP micro-bench)
"""

__version__ = "0.1.0"
