"""mfu.<scope>: the model FLOPs of the window (2 x the forward's
multiply-accumulates an image, from the frozen count_macs) over the
window's wall, as a share of the H100's bf16 tensor-core peak (989
TFLOP/s at 700 W). Layer: whole program."""

from ..yardstick.peaks import BF16_FLOPS


def read(drv):
    if not drv.wall or not drv.window_flops:
        return None
    return 100.0 * drv.window_flops / drv.wall / BF16_FLOPS
