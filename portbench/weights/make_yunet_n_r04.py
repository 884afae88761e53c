"""Writes ``yunet_n_r04.npz`` beside this file: the r04 EMA weights of
yunet_n (``tests/fixtures/r04_ema.npz``, flat JAX leaves) under the
reference checkpoint's names, float32, BN running statistics included.
Run once on the CPU from the repository root:

    python -m portbench.weights.make_yunet_n_r04

``portbench/tests/test_portbench_weights.py`` holds the file equal to what
the port reads from the fixture.
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(HERE)), "tests",
                       "fixtures", "r04_ema.npz")


def main():
    from yunet_tpu_torch.config import yunet_n
    from yunet_tpu_torch.utils.jax_params import (load_flat_npz,
                                                  state_dict_from_jax)
    sd = state_dict_from_jax(*load_flat_npz(FIXTURE, yunet_n().model))
    np.savez(os.path.join(HERE, "yunet_n_r04.npz"),
             **{k: v.numpy() for k, v in sd.items()
                if not k.endswith("num_batches_tracked")})


if __name__ == "__main__":
    main()
