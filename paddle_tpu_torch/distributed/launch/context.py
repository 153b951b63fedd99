"""The launcher's arguments and environment.

Counterpart of ``paddle_tpu/distributed/launch/context.py``: the same
arguments, each defaulting to its ``PADDLE_*`` variable. This launcher
runs one node: ``--nnodes`` above 1 and the elastic levels
(``--elastic_level`` >= 0, or ``--nnodes MIN:MAX``) raise, naming their
ROADMAP.md items.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Args:
    master: Optional[str] = None      # ip:port of the job's store
    nnodes: int = 1
    np_min: int = 1
    node_rank: int = 0
    nproc_per_node: int = 1
    job_id: str = "default"
    log_dir: str = "log"
    devices: Optional[str] = None     # "cpu", or card indices "0,1,..."
    run_mode: str = "collective"
    max_restart: int = 3
    elastic_level: int = -1
    elastic_timeout: int = 30
    training_script: str = ""
    training_script_args: List[str] = field(default_factory=list)


def _nnodes_spec(raw: str):
    try:
        if ":" in raw:
            lo, hi = raw.split(":", 1)
            np_min, np_max = int(lo), int(hi)
        else:
            np_min = np_max = int(raw)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected N or MIN:MAX, got {raw!r}")
    if np_min < 1 or np_min > np_max:
        raise argparse.ArgumentTypeError(f"{raw!r}: need 1 <= MIN <= MAX")
    return np_min, np_max


def parse_args(argv: Optional[List[str]] = None) -> Args:
    env = os.environ
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="Start N ranks of a training script on this node and "
                    "watch them (collective mode).")
    p.add_argument("--master", default=env.get("PADDLE_MASTER"),
                   help="the job's store ip:port (default: a free local "
                        "port)")
    p.add_argument("--nnodes", type=_nnodes_spec,
                   default=env.get("PADDLE_NNODES", "1"))
    p.add_argument("--node_rank", type=int,
                   default=int(env.get("PADDLE_NODE_RANK", 0)))
    p.add_argument("--nproc_per_node", type=int,
                   default=int(env.get("PADDLE_NPROC_PER_NODE", 1)))
    p.add_argument("--job_id", default=env.get("PADDLE_JOB_ID", "default"))
    p.add_argument("--log_dir", default=env.get("PADDLE_LOG_DIR", "log"))
    p.add_argument("--devices", default=env.get("PADDLE_DEVICES"),
                   help="'cpu', or one card index per rank ('0,1,2,3'; "
                        "'0,0' puts two ranks on card 0, for gloo)")
    p.add_argument("--run_mode", default="collective", choices=["collective"])
    p.add_argument("--max_restart", type=int, default=3,
                   help="restarts of the whole pod after a failed rank")
    p.add_argument("--elastic_level", type=int,
                   default=int(env.get("PADDLE_ELASTIC_LEVEL", -1)))
    p.add_argument("--elastic_timeout", type=int,
                   default=int(env.get("PADDLE_ELASTIC_TIMEOUT", 30)))
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    ns = p.parse_args(argv)
    np_min, np_max = (_nnodes_spec(ns.nnodes)
                      if isinstance(ns.nnodes, str) else ns.nnodes)
    ns.nnodes = np_max
    if np_min < np_max and ns.elastic_level < 0:
        ns.elastic_level = 1
    args = Args(**vars(ns))
    args.np_min = np_min
    if args.elastic_level >= 0:
        raise NotImplementedError(
            "launch: elastic levels need the elastic manager, ROADMAP.md "
            "A8(e)")
    if args.nnodes > 1:
        raise NotImplementedError(
            "launch: this launcher runs one node (--nnodes 1); the "
            "multi-node rendezvous comes with the elastic manager, "
            "ROADMAP.md A8(e)")
    return args


class Context:
    def __init__(self, argv: Optional[List[str]] = None):
        self.args = parse_args(argv)
        self.envs = dict(os.environ)
        self.node_ip = self.envs.get("POD_IP", "127.0.0.1")
        self.status = "ready"
