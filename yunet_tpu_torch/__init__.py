"""yunet_tpu_torch — the YuNet serving path in PyTorch, for NVIDIA Hopper.

A port of the JAX package ``yunet_tpu`` (which stays the numerical
reference) to PyTorch. Module names follow ``yunet_tpu`` so each module's
counterpart is easy to find. The package imports ``torch`` and never
``jax`` or ``yunet_tpu``.

Layout:
  config.py        dataclass presets (a copy of yunet_tpu.config)
  models/          ConvDPUnit / backbone / TFPN neck / head / detector as
                   nn.Modules named like the reference checkpoint keys;
                   fused.py folds BN and runs the fused-unit forward
  ops/             priors, box decode, fused ConvDPUnit and greedy NMS
                   (each a hand-written CUDA kernel beside its plain
                   PyTorch version), the nvcc build helper
  csrc/            the CUDA sources, built at first use into _build/
  utils/           JAX-pytree / .npz / .pth parameter bridge
  eval/detect.py   Detector: preprocess -> forward -> decode -> NMS
  native.py        exact host greedy NMS (the JAX package's C++ source)
  apis.py          init_detector / inference_detector
"""

__version__ = "0.1.0"
