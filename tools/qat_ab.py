"""QAT of ResNet-50 on one H100: this tree against an older one, and the
spread of the QAT model's first loss card vs CPU over seeds.

    python3 tools/qat_ab.py [--parent DIR] [--seeds 8] [--out FILE]

Training: turns parent, change, change, parent (change, change without
``--parent``), each a fresh process that imports ``chip_smoke`` from its
tree and runs phase ``quant_qat``'s QAT training (``qat_build``, then
``train_run`` with step capture off: ``QAT_STEPS`` steps at b 64 on
224 x 224) and one profiled eager step: images/s, step p50 / p99, and the
device's busy ms and share of that step's wall time. ``DIR`` is a
checkout of the older tree (``git archive`` unpacked under ``build/``);
both trees' kernels are built first, side by side.

Spread: in this tree, ``chip_smoke.qat_vs_cpu`` for seeds 0 .. N-1 (the
weights from the seed, the batch drawn from ``seed + 40`` as the phase
draws it): the first loss card vs CPU on ``QAT_CPU_ROWS`` images, and the
worst teacher-forced layer and scale errors.

Prints one line per measurement and writes them all as JSON to ``--out``
(default ``chiprun_out/qat_ab.json``). Needs one card; about 4 minutes
with a parent and 8 seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MARK = "QAT_AB "


def _phase_inputs(torch, np, cs, seed):
    rng = np.random.RandomState(seed + 40)
    x = torch.from_numpy(rng.randn(cs.R50_B, 3, cs.R50_SIZE, cs.R50_SIZE)
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 1000, cs.R50_B)).cuda()
    return x, y


def child(root: str, what: str, seeds: int) -> dict:
    """One measurement in this process, with ``root``'s package."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import chip_smoke as cs
    torch.backends.cudnn.deterministic = True       # as the phase runs
    if what == "train":
        x, y = _phase_inputs(torch, np, cs, 0)
        run, train = cs.train_run(
            torch, lambda: cs.qat_build(torch, 0), (x,), (y,), cs.QAT_STEPS,
            "images", cs.R50_B, capture=False)
        prof = cs.profiled_eager_step(torch, train, x, y)
        return dict(root=root, **{k: run[k] for k in (
            "images_per_s", "step_ms_p50", "step_ms_p99", "losses",
            "fused_optimizer_launches")}, **{k: prof.get(k) for k in (
                "device_busy_ms", "wall_ms", "busy_share_of_wall",
                "launches", "not_measured")})
    out = []
    for seed in range(seeds):
        x, y = _phase_inputs(torch, np, cs, seed)
        c = cs.qat_vs_cpu(torch, seed, x, y)
        c["seed"] = seed
        out.append(c)
        print(MARK + json.dumps(c), flush=True)
    return dict(root=root, seeds=out, first_loss_rel_max=max(
        c["first_loss_rel"] for c in out))


def run_child(root: Path, what: str, seeds: int) -> dict:
    p = subprocess.run([sys.executable, __file__, "--child", str(root),
                        "--what", what, "--seeds", str(seeds)],
                       capture_output=True, text=True, cwd=str(root))
    sys.stderr.write(p.stderr[-4000:])
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith(MARK)]
    if p.returncode != 0 or not lines:
        raise RuntimeError(f"{what} in {root} failed (rc {p.returncode})")
    return json.loads(lines[-1][len(MARK):])


def build_trees(roots) -> None:
    """Every tree's kernels, the builds side by side."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from "
            "paddle_tpu_torch.ops.kernels import _build; "
            "print(_build.build_all())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              cwd=str(r)) for r in roots]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError("a kernel build failed")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "qat_ab.json"))
    ap.add_argument("--child")
    ap.add_argument("--what", default="train")
    args = ap.parse_args(argv)
    if args.child:
        print(MARK + json.dumps(child(args.child, args.what, args.seeds)),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("qat_ab: no CUDA device", file=sys.stderr)
        return 2
    parent = Path(args.parent).resolve() if args.parent else None
    build_trees([ROOT] + ([parent] if parent else []))
    turns = ([("parent", parent), ("change", ROOT), ("change", ROOT),
              ("parent", parent)] if parent else
             [("change", ROOT), ("change", ROOT)])
    res = {"device": torch.cuda.get_device_name(0), "train": []}
    for tag, root in turns:
        r = run_child(root, "train", 0)
        r["tree"] = tag
        res["train"].append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "losses"}),
              flush=True)
    if args.seeds:
        res["spread"] = run_child(ROOT, "spread", args.seeds)
        print(json.dumps({"first_loss_rel_max":
                          res["spread"]["first_loss_rel_max"]}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
