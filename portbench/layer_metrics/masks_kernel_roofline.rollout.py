"""masks_kernel_roofline.rollout: % of the masks kernel's least time (K1,
ops/csrc/masks.cu) in its device time a launch in the traced call. Least
time: its class masks (B x L x H x W bytes) written once at the HBM
rate; the compacted segments it reads (about 1% of that) are not
counted, so the share is a lower bound."""
from portbench import readers


def read(ctx):
    return readers.kernel_roofline(ctx, "masks_kernel",
                                   ctx.facts.get("masks_bytes"))
