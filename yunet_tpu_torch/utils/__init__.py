"""Parameter bridge to the JAX package's pytrees and checkpoint loaders."""
