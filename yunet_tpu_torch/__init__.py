"""yunet_tpu_torch — the YuNet serving path, WIDER Face evaluation,
single-device training and export in PyTorch, for NVIDIA Hopper.

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
  ops/             priors, boxes, losses, SimOTA assignment, a bilinear
                   resize with cv2.resize's bytes, OpenCV's uint8 colour
                   conversions (color.py) and float32 perspective warp
                   (warp.py); fused
                   ConvDPUnit (forward, trainable backward, channels-major
                   variant), greedy NMS and streamed SimOTA (each a
                   hand-written CUDA kernel beside its plain PyTorch
                   version); the nvcc build helper
  train/           targets, LR schedule, EMA, SGD and the train step;
                   the loop (fit: logging, finite-loss guard, checkpoints,
                   auto-resume, eval cadence), torch checkpoints, hooks
  csrc/            the CUDA sources and the host NMS source, built at
                   first use into _build/
  utils/           JAX-pytree / .npz / .pth parameter bridge; AutoRank;
                   the logger and metrics.jsonl; the environment report;
                   the analytic MAC / parameter count (flops.py)
  data/            labelv2 parser, decoded-image (.npy) cache, the train
                   augmentations (crop, cv2-exact resize, flip), the
                   dataset, the forked-worker TrainLoader and the
                   side-stream device_prefetch; device-side augmentation;
                   the extended library (aug_extra, auto_augment)
  eval/            Detector (preprocess -> forward -> decode -> NMS, the
                   WIDER sweep, TTA, Detector.mesh over several devices);
                   the WIDER protocol and VOC mAP; the in-training WIDER
                   eval hook
  export/          ONNX (own protobuf codec; files byte-equal to the JAX
                   package's), the libfacedetection C++ weight file,
                   TFLite (TensorFlow, imported lazily), the ONNX import
                   into a folded tree, and a torch ONNX executor
  native.py        exact host greedy NMS and the WIDER matcher
                   (csrc/host_nms.cpp, a copy of the JAX package's source)
  apis.py          init_detector (also from a training checkpoint) /
                   inference_detector / train_detector / random seeds
  tools/           train (the training CLI; smoke_data for --smoke;
                   dist_train.sh), test_widerface (WIDER val AP), test
                   (VOC mAP), detect_image (one image; .npy without
                   OpenCV), yunet2onnx / yunet2cpp / yunet2tflite /
                   get_flops, make_synth_wider (the synthetic WIDER
                   generator, both tiers; renders need OpenCV),
                   compare_inference (cross-engine FPS and AP),
                   run_rehearsal (kill, auto-resume, bit-exact check),
                   ema_ab_table, export_band_fixture, quant_ap_study
                   (TensorFlow host), verify_device_kernels,
                   profile_serve / profile_train_step, bench_train_step /
                   bench_input_pipeline / bench_resample /
                   bench_convdp_cm, validate_training, and the small data
                   CLIs (print_config, subset_labelv2, get_image_metas,
                   build_decoded_cache, browse_dataset)

Training on the CPU (the tests' way):
  from yunet_tpu_torch.tools.train import main
  main(["yunet_n", "--smoke", "--max-steps", "2", "--work-dir", "w",
        "--cfg-options", "data.img_size=96"], device="cpu")
On the card, ``python -m yunet_tpu_torch.tools.train yunet_n
--cfg-options data.decoded_cache=...``: the card host has no OpenCV, so
images come from the decoded ``.npy`` cache (data/cache.py).
"""

__version__ = "0.1.0"
