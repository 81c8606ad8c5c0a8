"""The control of a cell's comparison, and the fault of a loop node whose
PGO does nothing, read at the cell's own size.

    python3 slambench/control.py --workload <name> --seeds <n> [<n> ...]
        --seconds S [--tf32]

For each seed the program runs the cell as run.py runs it (set-up, a
window of S seconds); then three sets of outputs are judged by the cell's
limits, and each prints one line: its numbers, each limit, the numbers
over their limits, and correct.
  - program: the program's own outputs (a sound run);
  - bfloat16 reference: the reference put in the program's place in
    bfloat16: every frame's pose the truth's, worked out in bfloat16 from
    the scene's world frame, and every keyframe's corrected pose the
    reference's pose-graph solve (from the run's odometry and loop edges)
    rounded to bfloat16;
  - PGO left out: the program's outputs with every keyframe's corrected
    pose put back to its odometry pose, as a loop node whose PGO returns
    at once leaves them.
With --tf32 the program runs with TF32 allowed in matrix products and
convolutions (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32),
which it turns off when it is imported.
The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
for _p in (HERE.parent, HERE):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import reference  # noqa: E402


def bf16_outputs(outputs: list, gt, pgo: dict) -> list:
    """The reference in the program's place, in bfloat16 (module note):
    every frame of the run TRACKING at the truth's pose, every keyframe at
    the reference solve's pose."""
    out = []
    for s, o in enumerate(outputs):
        fid = np.arange(o["frames"])
        C = reference.round_to(reference.round_to(gt[s][fid % len(gt[s])], "bfloat16")
                               - reference.round_to(gt[s][0], "bfloat16"), "bfloat16")
        o = dict(o, frame_id=fid, status=np.ones(len(fid), int),
                 q=np.tile([1.0, 0.0, 0.0, 0.0], (len(fid), 1)), t=-C)
        lp = o["loop"]
        if lp is not None:
            q, t, _ = reference.pgo_reference(lp["odom_q"], lp["odom_t"], lp["edges"],
                                              lp["calls"], len(lp["frame_id"]), pgo)
            o["loop"] = dict(lp, q=reference.round_to(q, "bfloat16"),
                             t=reference.round_to(t, "bfloat16"))
        out.append(o)
    return out


def pgo_left_out(outputs: list) -> list:
    """The program's outputs with the keyframes' corrected poses put back
    to their odometry poses."""
    return [dict(o, loop=dict(o["loop"], q=o["loop"]["odom_q"], t=o["loop"]["odom_t"]))
            if o["loop"] is not None else o for o in outputs]


def readings(outputs: list, gt, cell: dict) -> list:
    """[(kind, numbers, checks, names over their limits, correct)] of the
    program, the bfloat16 reference and the PGO left out."""
    pgo = cell["config"]["pgo"]
    res = []
    for kind, outs in (("program", outputs), ("bfloat16 reference", bf16_outputs(outputs, gt, pgo)),
                       ("PGO left out", pgo_left_out(outputs))):
        nums = reference.numbers(outs, gt, pgo)
        ok, checks = reference.judge(nums, cell["limits"])
        over = [k for k, c in checks.items() if c["value"] is None or c["value"] > c["limit"]]
        res.append((kind, nums, checks, over, ok))
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--tf32", action="store_true")
    args = p.parse_args(argv)
    import torch

    import run
    from spec import Spec

    run.set_caches(Path.cwd())
    spec = Spec(Path.cwd())
    import flvis_tpu_torch  # noqa: F401  (its import turns TF32 off: allow it after)

    torch.backends.cuda.matmul.allow_tf32 = args.tf32
    torch.backends.cudnn.allow_tf32 = args.tf32
    for seed in args.seeds:
        out, outputs, gt, cell = run.measure(spec, args.workload, seed, args.seconds, False,
                                             "cuda", time.perf_counter())
        for kind, nums, checks, over, ok in readings(outputs, gt, cell):
            if kind == "program" and args.tf32:
                kind = "program with TF32"
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "numbers": nums, "checks": checks, "over": over, "correct": ok,
                              "metrics": out["metrics"] if kind.startswith("program") else {}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
