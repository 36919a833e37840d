"""Training CLI of the port:

    python -m reviews4rec_torch --model_type deepconn --dataset <name> ...

Every `HyperParams` field is a flag, generated from the dataclass (bools
take 1/true/yes/on, tuples comma-separated values), as in the JAX
package's `python -m reviews4rec_tpu`. The run trains and evaluates one
model on `<data_root>/<dataset>/<k>_core/corpus.npz` and prints the
final metric row and the log path, or with `--json` the metrics as one
JSON line. `--device` picks the device (default: the GPU; 'cpu' runs
the plain PyTorch path without one).

A mesh (`--mesh_shape D,M`) runs as D * M processes, one a device, each
started with the same flags plus `--coordinator host:port
--num_processes D*M --process_id i` (or torch's MASTER_ADDR,
MASTER_PORT, WORLD_SIZE and RANK in the environment), as the JAX
package's multi-host flags: `parallel.distributed.initialize` brings up
the process group, and rank i drives card i % the host's cards (or the
CPU under `--device cpu`). Every rank prints the same `--json` line;
only the primary (rank 0) prints the rest and writes logs, checkpoints
and `--save_predictions`.

Preprocessing has its own CLI: `python -m reviews4rec_torch.data.preprocess`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import typing

from .config import ALL_MODELS, HyperParams



def _tuple_parser(elem_type):
    def parse(s: str):
        s = s.strip()
        if not s:
            return ()
        return tuple(elem_type(x) for x in s.split(","))
    return parse


def _bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes", "on")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m reviews4rec_torch",
        description="Train + evaluate one model on a preprocessed dataset "
                    "(test MSE, HR@k/NDCG@k, count-vs-MSE maps).",
        epilog="Preprocess raw Amazon/RateBeer data first with "
               "`python -m reviews4rec_torch.data.preprocess`.")
    hints = typing.get_type_hints(HyperParams)
    for f in dataclasses.fields(HyperParams):
        t = hints[f.name]
        kw = {"default": None, "help": f"default: {f.default!r}"}
        if t is bool:
            kw["type"] = _bool
            kw["metavar"] = "BOOL"
        elif typing.get_origin(t) is tuple:
            kw["type"] = _tuple_parser(typing.get_args(t)[0])
            kw["metavar"] = "X,Y,..."
        else:
            kw["type"] = t
        if f.name == "model_type":
            kw["choices"] = ALL_MODELS
        p.add_argument(f"--{f.name}", **kw)
    p.add_argument("--json", action="store_true",
                   help="print the final metrics as one JSON line")
    p.add_argument("--save_predictions", action="store_true",
                   help="after training, write <tag>_{split}_results "
                        "prediction artifacts for train/test/val to "
                        "--log_dir")
    p.add_argument("--device", default=None,
                   help="device to run on (default: the GPU; 'cpu' to run "
                        "without one)")
    # the JAX package's multi-host flags: one process a device here
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="address of rank 0's rendezvous in a "
                        "multi-process run (torch.distributed, tcp)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="processes of a multi-process run: one a device "
                        "of --mesh_shape")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank, in [0, --num_processes)")
    return p


def hp_from_args(args: argparse.Namespace) -> HyperParams:
    overrides = {f.name: getattr(args, f.name)
                 for f in dataclasses.fields(HyperParams)
                 if getattr(args, f.name) is not None}
    return HyperParams(**overrides)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    hp = hp_from_args(args)
    from .parallel import distributed
    multi = distributed.initialize(
        args.coordinator, args.num_processes, args.process_id,
        device=args.device)
    if multi:
        device = distributed.device()
    else:
        from .utils.device import resolve_device
        device = resolve_device(args.device)
    primary = distributed.is_primary()

    data_dir = hp.data_dir()
    if not os.path.exists(os.path.join(data_dir, "corpus.npz")):
        print(f"error: no preprocessed corpus at {data_dir}/corpus.npz — "
              f"run `python -m reviews4rec_torch.data.preprocess` first",
              file=sys.stderr)
        return 2

    from .api import run
    from .data.corpus import ReviewDataset
    dataset = ReviewDataset.load(data_dir)
    metrics, _, _ = run(hp, dataset, quiet=False, device=device)
    if multi:
        distributed.shutdown()
    if args.json:
        print(json.dumps(metrics))
    if not primary:
        return 0

    if args.save_predictions:
        if hp.family in ("id", "review"):
            from .serve import save_predictions
            paths = save_predictions(hp, dataset, device=device)
            for split, path in paths.items():
                print(f"predictions[{split}]: {path}", file=sys.stderr)
        elif hp.family == "topic":
            print("--save_predictions: HFT already writes its per-split "
                  "prediction artifacts during training (models/hft.py "
                  "run_hft) — see "
                  f"{hp.log_dir}/{hp.run_tag()}_HFT_*_results",
                  file=sys.stderr)
        else:
            print(f"--save_predictions is not supported for the "
                  f"{hp.family!r} family ({hp.model_type}): neighborhood "
                  f"models have no persisted checkpoint to score from — "
                  f"use reviews4rec_torch.models.neighbors.run_neighbor "
                  f"in-process instead", file=sys.stderr)
    if not args.json:
        body = " | ".join(f"{k} = {v}" for k, v in metrics.items())
        print(f"\nFINAL ({hp.model_type} on {hp.dataset}): {body}")
        print(f"log: {hp.log_file()}")
        if hp.save_model and hp.family in ("id", "review"):
            from .train.checkpoint import checkpoint_path
            print(f"model: {checkpoint_path(hp)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
