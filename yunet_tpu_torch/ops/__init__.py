"""Fused ConvDPUnit, greedy NMS, priors and box decode; the CUDA build helper."""
