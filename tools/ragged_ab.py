"""Ragged paged attention on one H100: the wrapper's schedule constants
against their alternatives, at ``chip_smoke.py``'s four ragged mixes.

    python3 tools/ragged_ab.py [--seed 0] [--rounds 2] [--out FILE]

Each variant is a setting of the wrappers' module constants (no rebuild:
the kernels take them as arguments):

- ``kept``: the tree's own (``MIN_PIECE``, ``TILE_ITEMS_PER_SM``,
  ``SPLIT_BLOCKS_PER_SM`` as committed);
- ``unsplit``: every tile of the tile pass one piece (``MIN_PIECE`` above
  any tile's steps), so no tile writes piece records and the merge only
  skips over them: the parent's unsplit tiles on this tree's kernels;
- ``items2`` / ``items8``: 2 / 8 extra tile-pass work items an SM;
- ``split8`` / ``split32``: a split plan of 8 / 32 blocks an SM (the plan
  the gang decode shares).

At each mix (``chip_smoke.RAGGED_MIXES``: the smoke mix, the engine's
decode, prefill and verify steps over the 1024-block pool) with a bf16
and an int8 pool (the smoke mix also float32), every variant's output is
held against the plain version (``chip_smoke.check_close``, its TOL) and
then timed with ``chip_smoke.time_ms`` (CUDA events, L2 flushed, median
of 10) in ``--rounds`` rounds, the variants in order and then reversed,
so that drift favours none. Prints the card's name and power limit and
one line per case; writes every reading as JSON to ``--out`` (default
``chiprun_out/ragged_ab.json``). Needs one card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from paddle_tpu_torch.ops.kernels import paged_attention as pa  # noqa: E402
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa  # noqa: E402,E501

KEPT = dict(MIN_PIECE=rpa.MIN_PIECE, TILE_ITEMS_PER_SM=rpa.TILE_ITEMS_PER_SM,
            SPLIT_BLOCKS_PER_SM=pa.SPLIT_BLOCKS_PER_SM)
VARIANTS = {
    "kept": {},
    "unsplit": dict(MIN_PIECE=1 << 20),
    "items2": dict(TILE_ITEMS_PER_SM=2),
    "items8": dict(TILE_ITEMS_PER_SM=8),
    "split8": dict(SPLIT_BLOCKS_PER_SM=8),
    "split32": dict(SPLIT_BLOCKS_PER_SM=32),
}


def use(variant: str) -> None:
    """Sets the wrappers' constants to ``variant``'s."""
    cfg = {**KEPT, **VARIANTS[variant]}
    rpa.MIN_PIECE = cfg["MIN_PIECE"]
    rpa.TILE_ITEMS_PER_SM = cfg["TILE_ITEMS_PER_SM"]
    pa.SPLIT_BLOCKS_PER_SM = cfg["SPLIT_BLOCKS_PER_SM"]
    pa.split_plan.cache_clear()


def cases(seed: int):
    """``(name, args, kw)`` for every mix and pool dtype, built as
    ``chip_smoke.ragged_cases`` builds them."""
    rng = np.random.RandomState(seed)
    q, kp, vp, tbl, ctx, cu = cs.smoke_layout(torch, rng, torch.bfloat16)
    kq, vq, ks, vs = cs.quantized_pools(torch, kp, vp)
    g = torch.Generator(device="cuda").manual_seed(int(rng.randint(1 << 30)))
    for mix, rows in cs.RAGGED_MIXES.items():
        if mix != "smoke_mix":
            tbl, ctx, cu = (torch.from_numpy(a).cuda()
                            for a in cs.mix_tables(rng, rows))
            q = torch.randn((cs.SMOKE_T, cs.H, cs.D), generator=g,
                            device="cuda").to(torch.bfloat16)
        yield f"{mix}/bfloat16", (q, kp, vp, tbl, ctx, cu), {}
        yield f"{mix}/int8", (q, kq, vq, tbl, ctx, cu), dict(k_scale=ks,
                                                             v_scale=vs)
        if mix == "smoke_mix":
            yield (f"{mix}/float32", (q.float(), kp.float(), vp.float(), tbl,
                                      ctx, cu), {})


def measure(name, args, kw, rounds: int, flush) -> dict:
    q, kp, tbl, ctx, cu = args[0], args[1], args[3], args[4], args[5]
    dname = "float32" if q.dtype == torch.float32 else "bfloat16"
    want = rpa.ragged_paged_attention_plain(*args, **kw)
    call = lambda: rpa.ragged_paged_attention(*args, **kw)  # noqa: E731
    res = {}
    for v in VARIANTS:
        use(v)
        piece, items = rpa.call_schedule(q, kp, tbl, ctx, cu)
        res[v] = dict(
            max_abs_err=cs.check_close(torch, f"{name} {v}", call(), want,
                                       dname, int(cu[-1])),
            plan=pa.call_plan(q, kp, tbl), piece_steps=piece,
            tile_items=len(items), ms_readings=[])
    order = list(VARIANTS)
    for r in range(rounds):
        for v in (order if r % 2 == 0 else order[::-1]):
            use(v)
            res[v]["ms_readings"].append(cs.time_ms(torch, call,
                                                    flush=flush))
    use("kept")
    for v in res.values():
        v["ms"] = float(np.median(v["ms_readings"]))
    cs.log(f"ragged_ab[{name}]: " + ", ".join(
        f"{v} {res[v]['ms']:.4f} ms ({res[v]['tile_items']} items of <= "
        f"{res[v]['piece_steps']} steps, plan {res[v]['plan']})"
        for v in VARIANTS))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "ragged_ab.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ragged_ab: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    cs.log(card)
    _build.build_all()
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res = dict(card=card, kept=KEPT, variants=VARIANTS)
    try:
        for name, args, kw in cases(a.seed):
            res[name] = measure(name, args, kw, a.rounds, scratch.zero_)
    finally:
        use("kept")
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
