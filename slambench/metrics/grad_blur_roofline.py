"""grad_blur's share of its roofline in the profiled slice: the bound of
the pyramids its launches built (roofline.grad_blur_build_s at the cell's
image size, one build a frame and image triple, `pyramid_levels` launches
each) over the launches' device time."""

import roofline


def read(rec):
    if rec.trace is None:
        return None
    n, dev_s = rec.trace.kernel("grad_blur_kernel")
    if not n or dev_s <= 0:
        return None
    c = rec.config
    levels = int(c["pyramid_levels"])
    bound = n / levels * roofline.grad_blur_build_s(int(c["image_height"]),
                                                    int(c["image_width"]), levels)
    return 100.0 * bound / dev_s
