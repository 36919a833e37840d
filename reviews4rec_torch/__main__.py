"""Training CLI of the port:

    python -m reviews4rec_torch --model_type deepconn --dataset <name> ...

Every `HyperParams` field is a flag, generated from the dataclass (bools
take 1/true/yes/on, tuples comma-separated values), as in the JAX
package's `python -m reviews4rec_tpu`. The run trains and evaluates one
model on `<data_root>/<dataset>/<k>_core/corpus.npz` and prints the
final metric row and the log path, or with `--json` the metrics as one
JSON line. `--device` picks the device (default: the GPU; 'cpu' runs
the plain PyTorch path without one).

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

MULTIHOST_FLAGS = ("coordinator", "num_processes", "process_id")


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
    # the JAX package's multi-host flags: parsed, refused when given
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host coordinator address (not ported: "
                        "ROADMAP.md Queue 1 item 13)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="processes of a multi-host run (not ported)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's index (not ported)")
    return p


def hp_from_args(args: argparse.Namespace) -> HyperParams:
    overrides = {f.name: getattr(args, f.name)
                 for f in dataclasses.fields(HyperParams)
                 if getattr(args, f.name) is not None}
    return HyperParams(**overrides)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    hp = hp_from_args(args)
    given = [f"--{k}" for k in MULTIHOST_FLAGS if getattr(args, k) is not None]
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: multi-host runs are not ported yet "
            f"(ROADMAP.md Queue 1 item 13)")

    from .utils.device import resolve_device
    device = resolve_device(args.device)

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
    if args.json:
        print(json.dumps(metrics))
    else:
        body = " | ".join(f"{k} = {v}" for k, v in metrics.items())
        print(f"\nFINAL ({hp.model_type} on {hp.dataset}): {body}")
        print(f"log: {hp.log_file()}")
        if hp.save_model and hp.family in ("id", "review"):
            from .train.checkpoint import checkpoint_path
            print(f"model: {checkpoint_path(hp)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
