"""The harness's knowledge of each model, one file a model:
`portbench/models/<model>.py`, found by a configuration's `model` value
letter for letter (a character outside letters, digits, `_`, `.` and
`-`, such as the `+` of `transnet++`, is written `_` in the file's
name). The shared harness (`weights`, `counts`, `reference`, `drivers`,
`run`) asks the file for everything that differs between models:

- `LEFT_OUT`: the program's state-dict keys the benchmark's weights
  leave out (the frozen word table, which the program takes from the
  corpus);
- `params(cfg, num_users, num_items)`: the (name, shape, init) of every
  parameter, in the program's state-dict layout (`weights.spec`);
- `towers(cfg)`: {"docs": docs a side per example, "t": words a doc,
  "e", "f", "w": the TextCNN's widths, "l": latent} (`counts`);
- `head_flop(cfg)`: the forward FLOP of one pair's head from the two
  towers' outputs (`counts`);
- `batch_inputs(ref, users, items)` and `forward(ref, w, users, items,
  inp, gen)`: the training documents of a batch and the rating
  prediction, in plain PyTorch on `reference.Reference`'s arithmetic;
- for a ranking cell, `rank_scores(ref, users, grid)`: the reference's
  [M, C] scores of each grid row's user against its candidates;
- optionally `objective(ref, pred, y)` (default: the mean squared
  error) and `update(ref, w, grads, state, step)` (default:
  `reference.adam_l2`), where the model trains otherwise, and
  `SHRUNK_HP`, the CPU tests' cut of the model's own sizes
  (`portbench.conftest.shrink`).
"""

from __future__ import annotations

import functools
import importlib.util
import os
import re
from types import ModuleType
from typing import Sequence

DIR = os.path.dirname(os.path.abspath(__file__))
REQUIRED = ("LEFT_OUT", "params", "towers", "head_flop", "batch_inputs",
            "forward")


def path(model: str) -> str:
    """The file that holds `model`'s part of the harness."""
    return os.path.join(DIR, re.sub(r"[^A-Za-z0-9_.-]", "_", model) + ".py")


@functools.lru_cache(maxsize=None)
def _load_file(file: str) -> ModuleType:
    if not os.path.isfile(file):
        raise FileNotFoundError(f"no harness file for this model: looked "
                                f"for {file}")
    name = "portbench_model_" + re.sub(r"\W", "_",
                                       os.path.basename(file)[:-3])
    spec = importlib.util.spec_from_file_location(name, file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(model: str, needs: Sequence[str] = ()) -> ModuleType:
    """`model`'s file, executed once a process (later calls find it
    resolved); it must define `REQUIRED` and `needs`."""
    file = path(model)
    mod = _load_file(file)
    missing = [n for n in REQUIRED + tuple(needs) if not hasattr(mod, n)]
    if missing:
        raise AttributeError(f"{file} defines no {', '.join(missing)}, "
                             f"which this entry needs")
    return mod


def need(mod: ModuleType, name: str):
    """`mod`'s function `name`, or an error that names both."""
    fn = getattr(mod, name, None)
    if fn is None:
        raise AttributeError(f"{mod.__file__} defines no {name}")
    return fn
