"""bias_prelu_roofline.stamps: the one-pass bias and PReLU's share of its
roofline in the traced batches, in percent: the least time the card could
take to move its bytes (work_bias_prelu.bias_prelu_bytes of each traced
batch, over the HBM bandwidth) over the device time of the kernels named
``bias_prelu`` in the trace.  A program without the kernel gives
nothing."""

from portbench.work import HBM_BYTES_PER_S
from portbench.work_bias_prelu import bias_prelu_bytes

KERNEL = "bias_prelu"


def read(ctx):
    if ctx.trace is None:
        return None
    seconds = sum(s for name, s in ctx.trace["device_op_s"].items() if KERNEL in name)
    if not seconds > 0:
        return None
    model = ctx.config["model"]
    itemsize = 2 if model["dtype"] == "bfloat16" else 4
    moved = ctx.trace["steps"] * bias_prelu_bytes(model, int(ctx.mix["batch"]), itemsize)
    return 100.0 * moved / HBM_BYTES_PER_S / seconds
