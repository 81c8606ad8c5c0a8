"""The port's example drivers: `python -m flvis_tpu_torch.run_synthetic_vo`
against examples/run_synthetic_vo.py (the JAX package) on the same
rendered sequence, and `python -m flvis_tpu_torch.run_multiseq` on the
example's scenes under its PASS bound.

Tolerances: run_synthetic_vo's per-frame statuses and keyframe flags
equal, inliers within ±2 and position errors within 0.1 cm of the JAX
run's (the two trackers draw their RANSAC hypotheses differently; the
poses come from the same inlier refinement), both runs PASS (ATE under
2 % of the path + 1 cm).  run_multiseq: every sequence under the example's
bound (2 % of the path + 1.5 cm), loops closed; the MultiSeqSlam it drives
is held against the JAX one in tests/test_torch_multiseq*.py."""

import importlib.util
import re
import sys
from pathlib import Path

import pytest
import torch

from flvis_tpu_torch import run_multiseq, run_synthetic_vo

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
FRAME = re.compile(r"frame +(\d+) +(\w+) +inliers= *(\d+) reproj= *([\d.]+)px +"
                   r"pos_err= *([\d.]+)cm( KF)?")


def _frames(text):
    return [(int(m[1]), m[2], int(m[3]), float(m[5]), bool(m[6]))
            for m in FRAME.finditer(text)]


def _jax_example(name, argv, capsys, monkeypatch):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    capsys.readouterr()
    rc = mod.main()
    return rc, capsys.readouterr().out


def test_run_synthetic_vo_matches_example(capsys, monkeypatch):
    argv = ["--cpu", "--frames", "6"]
    rc_t = run_synthetic_vo.main(argv)
    out_t = capsys.readouterr().out
    rc_j, out_j = _jax_example("run_synthetic_vo", argv, capsys, monkeypatch)
    assert rc_t == rc_j == 0
    assert "RESULT: PASS" in out_t and "RESULT: PASS" in out_j
    ft, fj = _frames(out_t), _frames(out_j)
    assert len(ft) == len(fj) == 6
    for (i, st, n, err, kf), (_, sj, nj, errj, kfj) in zip(ft, fj):
        assert (st, kf) == (sj, kfj), i
        assert abs(n - nj) <= 2, i
        assert abs(err - errj) <= 0.1, i


def test_run_synthetic_vo_viz_dir(tmp_path, capsys):
    """--backend --viz-dir: an overlay PNG a frame, a marker PLY a keyframe
    and the sparse map's PLY."""
    import cv2

    d = tmp_path / "viz"
    assert run_synthetic_vo.main(["--cpu", "--frames", "8", "--backend",
                                  "--viz-dir", str(d)]) == 0
    out = capsys.readouterr().out
    assert "RESULT: PASS" in out
    kfs = [f for f in _frames(out) if f[4]]
    assert len(list(d.glob("frame_*.png"))) == 8
    assert len(list(d.glob("marker_*.ply"))) == len(kfs) >= 2
    img = cv2.imread(str(d / "frame_0003.png"))
    assert img is not None and img.ndim == 3 and img.shape[2] == 3
    m = re.search(r"sparse map: (\d+) voxel points", out)
    assert m and int(m[1]) > 0
    head = (d / "sparse_map.ply").read_text().splitlines()
    assert head[0] == "ply" and f"element vertex {m[1]}" in head


def test_run_multiseq(capsys):
    assert run_multiseq.main(["--cpu", "--seqs", "2", "--frames", "32", "--loop"]) == 0
    out = capsys.readouterr().out
    assert "RESULT: PASS" in out
    seqs = re.findall(r"seq (\d): ATE +([\d.]+) cm over ([\d.]+) m \(ok\)  loops=(\d+)", out)
    assert len(seqs) == 2
    assert all(int(loops) >= 1 for *_, loops in seqs)
    # --mesh in one process: a mesh of one rank holding both sequences.
    assert run_multiseq.main(["--cpu", "--mesh", "--seqs", "2", "--frames", "16"]) == 0
    out = capsys.readouterr().out
    assert "RESULT: PASS" in out and len(re.findall(r"seq \d: ATE", out)) == 2
