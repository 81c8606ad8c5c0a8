"""Run one cell of the flvis_tpu_torch benchmark once.

    python3 slambench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (BENCHMARK.json's `workloads`)
names a configuration (a file of sizes under slambench/configs/) and a
traffic mix (slambench/traffic/<traffic>.json).  The run renders the
cell's stream on the card from the seed, builds the program's entry,
warms it up on the stream's first frames, measures for `--seconds`, then
holds every pose the program returned to the plain reference
(reference.py) with the cell's limits (slambench/limits/<workload>.json).
With --trace 0 it reports the cell's end-to-end metrics, with --trace 1
its per-layer metrics (instruments.py).  The last line of standard output is
one JSON object: correct, attempted, failed, metrics, device
[, breakdown], checks.  Standard error ends with every number the
reference worked out (and, under `loop_nodes`, each loop node's
keyframes at the end and at the window's start, closures, and PGO calls),
then each compared number beside its limit.  It exits non-zero and prints no result without
enough CUDA devices, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
for _p in (HERE.parent, HERE):          # the checkout (the program), then the harness
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

# Top-level module names that must not be loaded, compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "flvis_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def set_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's kernel library builds into flvis_tpu_torch/_build)."""
    cache = root / ".slambench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def card() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def measure(spec, workload: str, seed: int, seconds: float, traced: bool, device: str,
            t_start: float):
    """One run of the cell on `device`: (the result's keys but the verdict,
    the program's outputs, the stream's truth, the cell)."""
    import torch

    import driver
    from instruments import Tracer

    cell = spec.cell(workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tr, c = cell["traffic"], cell["config"]
    sut, stream = driver.build(cell, seed, dev)
    for frames, chunk in tr["warmup"]:
        for _ in range(int(frames) // int(chunk)):
            sut.chunk(int(chunk))
    driver.sync(dev)
    rec = driver.Record(config=c)
    tracer = Tracer(sut, tr, seconds, dev) if traced else None
    rec.trace = tracer
    first = sut.next                    # the first frame the window drives
    driver.mark_window(sut)
    rec.setup_s = time.perf_counter() - t_start
    driver.run_window(sut, tr, rec, seconds, tracer)
    sut.finish()
    driver.sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    metrics = {}
    for name, unit, read in spec.metrics(workload, traced):
        v = read(rec)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": unit}
    outputs = sut.outputs(first)
    breakdown = tracer.breakdown() if tracer is not None else {}
    busy = tracer.busy() if tracer is not None else None
    del sut, tracer
    rec.trace = None
    out = {"attempted": int(sum(o["frames"] - o["first"] for o in outputs)),
           "failed": 0, "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if busy is not None:
        out["device"]["busy_s"], out["device"]["window_s"] = busy
    if breakdown:
        out["breakdown"] = breakdown
    return out, outputs, stream.gt_centres, cell


def verdict(out: dict, outputs: list, gt, cell: dict) -> dict:
    """The result with the reference's verdict: correct first, the numbers
    (printed to standard error) and the checks last."""
    import reference

    nums = reference.numbers(outputs, gt, cell["config"]["pgo"])
    correct, checks = reference.judge(nums, cell["limits"])
    out = dict(out, failed=int(nums["missing"] + nums["not_tracking"]))
    loops = [o["loop"] for o in outputs if o["loop"] is not None]
    nums["loop_nodes"] = [[len(lp["frame_id"]), lp["at_window"], len(lp["edges"]),
                           len(lp["calls"])] for lp in loops]
    return dict({"correct": bool(correct)}, **out, numbers=nums, checks=checks)


def run_cell(spec, workload: str, seed: int, seconds: float, traced: bool, device: str,
             t_start: float) -> dict:
    """One run of the cell on `device`; returns the result object."""
    return verdict(*measure(spec, workload, seed, seconds, traced, device, t_start))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    set_caches(root)
    import torch

    from spec import Spec

    spec = Spec(root)
    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    out = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    bad = forbidden_modules()
    if bad:
        print(f"modules that must not be loaded were loaded: {bad}", file=sys.stderr)
        return 3
    print(f"card: {card()}; numbers: {json.dumps(out.pop('numbers'))}", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
