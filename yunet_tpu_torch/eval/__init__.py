"""Inference: the Detector."""
