"""cuSOLVER's SVD drivers on one card, at the shapes the port's SVD users
run, each against a float64 SVD of the same input.

    python3 tools/svd_drivers.py [--seed 0] [--out FILE]

Drivers: torch's default (``None``; ``gesvdj`` for these shapes),
``gesvdj`` by name and ``gesvd`` (what ``ops/kernels/linalg_fft.svd_on``
picks on the card). Shapes, float32:

- 64 x 256 x 256, twice: ``chip_smoke.py``'s linalg phase's matrices
  (``I + 0.5 N / 16``, what its ``pinv`` and ``det`` read) and Gaussian
  ones (``N / 16``);
- Gaussian 16 x 512², 4 x 1024², 2048², 4096², and 4096 x 14336 (a
  Llama-3-8B MLP gradient, GaLore's projection).

For each shape and driver: the ms of one call between CUDA events after
a first call; the singular values' largest error over the largest one,
against float64 ``gesvd`` on the card; the residual ``|U S Vh - A| /
|A|`` and the orthogonality ``max |U^H U - I|``, both in float64; and
whether each stays within ``chip_smoke.LINALG_LIMITS`` (``svd_values``
there is of sigma², twice the singular values' error). Prints one JSON
line per case and writes them all to ``--out`` (default
``chiprun_out/svd_drivers.json``). Needs one card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = [("phase", 64, 256, 256), ("gauss", 64, 256, 256),
          ("gauss", 16, 512, 512), ("gauss", 4, 1024, 1024),
          ("gauss", 1, 2048, 2048), ("gauss", 1, 4096, 4096),
          ("gauss", 1, 4096, 14336)]
DRIVERS = [None, "gesvdj", "gesvd"]


def matrices(rng, kind, b, m, n):
    a = rng.randn(b, m, n) / math.sqrt(n)
    if kind == "phase":
        a = np.eye(m) + 0.5 * a
    return torch.from_numpy(a.astype(np.float32)).cuda()


def timed(fn):
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def errors(a, u, s, vh, s64):
    a64, u64, vh64 = a.double(), u.double(), vh.double()
    eye = torch.eye(u.shape[-1], dtype=torch.float64, device=a.device)
    return dict(
        values=float((s.double() - s64).abs().max() / s64.abs().max()),
        residual=float(((u64 * s.double()[..., None, :]) @ vh64 - a64).norm()
                       / a64.norm()),
        orthogonality=max(float((u64.mH @ u64 - eye).abs().max()),
                          float((vh64 @ vh64.mH - eye).abs().max())))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "svd_drivers.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("svd_drivers: no CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import LINALG_LIMITS, card_line
    limits = dict(values=LINALG_LIMITS["svd_values"] / 2,
                  residual=LINALG_LIMITS["svd_reconstruction"],
                  orthogonality=LINALG_LIMITS["orthogonality"])
    rows = [dict(card=card_line())]
    print(json.dumps(rows[0]), flush=True)
    rng = np.random.RandomState(args.seed)
    for kind, b, m, n in SHAPES:
        a = matrices(rng, kind, b, m, n)
        a = a[0] if b == 1 else a
        s64 = torch.linalg.svdvals(a.double(), driver="gesvd")
        for drv in DRIVERS:
            (u, s, vh), ms = timed(lambda: torch.linalg.svd(
                a, full_matrices=False, driver=drv))
            err = errors(a, u, s, vh, s64)
            row = dict(data=kind, batch=b, m=m, n=n, driver=drv or "default",
                       ms=ms, **err,
                       within=all(err[k] <= limits[k] for k in limits))
            rows.append(row)
            print(json.dumps(row), flush=True)
            del u, s, vh
        del a, s64
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(limits=limits, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
