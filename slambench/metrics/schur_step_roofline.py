"""schur_step's share of its roofline in the profiled slice: one bound an
LM step (a schur_reduce_solve launch), its work counted from window BA's
windows at the slice's end (roofline.schur_step_s, the mean over the
sequences), over the device time of both of its kernels."""

import roofline


def read(rec):
    t = rec.trace
    if t is None or not t.ba_work:
        return None
    steps, solve_s = t.kernel("schur_reduce_solve")
    _, back_s = t.kernel("schur_backsub")
    if not steps or solve_s + back_s <= 0:
        return None
    per = sum(roofline.schur_step_s(*w) for w in t.ba_work) / len(t.ba_work)
    return 100.0 * steps * per / (solve_s + back_s)
