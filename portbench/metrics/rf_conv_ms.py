"""rf_conv_ms.<scope>: the device time of the convolution kernels in the
traced slice, a call, in ms: the union of their intervals, not the sum
(each launch of ``csrc/scrfd_conv.cu`` is a programmatic dependent of the
kernel before it, so consecutive conv intervals overlap by an epilogue);
None when none ran. Layer: trunk (RetinaFace-R50's folded convs, bf16,
channels-last).

The kernels, by their names in an H100 trace: the port's
``scrfd_fprop_kernel`` (``fprop`` in its name), and any library conv
left on the path: cuDNN's implicit-GEMM forward convolutions (``fprop``
in theirs), its channel padding (``nhwcAddPaddingKernel``) and cuBLAS's
GEMMs of 1x1 convs (``nvjet``)."""

NAMES = ("fprop", "nhwcAddPaddingKernel", "nvjet")


def conv_union_us(trace):
    """The union of the slice's convolution kernels' intervals, in us;
    None without one."""
    if trace is None:
        return None
    spans = sorted((t0, t1) for t0, t1, n in trace.kernels()
                   if any(k in n for k in NAMES))
    if not spans:
        return None
    total, lo, hi = 0.0, spans[0][0], spans[0][1]
    for t0, t1 in spans[1:]:
        if t0 > hi:
            total += hi - lo
            lo, hi = t0, t1
        else:
            hi = max(hi, t1)
    return total + hi - lo


def read(drv):
    us = conv_union_us(drv.trace)
    if us is None or not drv.slice_calls:
        return None
    return us / 1e3 / drv.slice_calls
