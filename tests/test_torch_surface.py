"""The port's public surface against the JAX package's, read from both
packages' sources by AST: neither package is imported, so this runs
where JAX is absent.

Every public top-level function, class and constant of each
`reviews4rec_tpu/<module>.py` has a name of the same spelling at the top
level of `reviews4rec_torch/<module>.py` (defined there or imported
into it), and every public method and property of `HyperParams`,
`Recommender` and `FactorizedRecommender` one in the port's class of
that name, unless the table below names it. The table is the list of
JAX names that deliberately have no counterpart of their own name: each
entry gives the port's counterpart (checked to exist) or the reason none
is needed. An entry whose JAX name is gone fails too, so the table
cannot go stale.
"""

import ast
from pathlib import Path
from typing import Dict, Optional, Set

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "reviews4rec_tpu"
PORT = ROOT / "reviews4rec_torch"
# a JAX module whose port has another file name
MODULE_OF = {"ops/textcnn_pallas.py": "ops/textcnn.py"}
CLASSES = {"config.py": ("HyperParams",),
           "serve.py": ("Recommender", "FactorizedRecommender")}

# (JAX module, name) -> the port's counterpart as "<module>::<name>"
COUNTERPART = {
    ("models/layers.py", "bias_lookup"): "models/layers.py::take_rows",
    ("models/layers.py", "embed_lookup"): "models/layers.py::take_rows",
    ("parallel/mesh.py", "replicate"): "parallel/mesh.py::shard_model",
    ("parallel/mesh.py", "shard_params"): "parallel/mesh.py::shard_model",
    ("parallel/mesh.py", "shard_batch"): "parallel/mesh.py::host_slice",
    ("train/evaluate.py", "make_eval_step"): "train/evaluate.py::eval_step",
    ("train/evaluate.py", "make_cached_eval_step"):
        "train/evaluate.py::evaluate_cached",
    ("train/evaluate.py", "make_rank_step"): "train/evaluate.py::score_grid",
    ("train/evaluate.py", "make_entity_rank_step"):
        "train/evaluate.py::assemble_entity_grid",
    ("train/loop.py", "make_train_step"): "train/loop.py::train_step",
    ("train/loop.py", "make_cached_train_step"):
        "train/loop.py::gather_cached_batch",
    ("train/loop.py", "make_scan_train_step"): "train/loop.py::ScanSteps",
    ("train/loop.py", "make_placer"): "utils/device.py::to_device",
    ("train/loop.py", "train_epoch_cached"): "train/loop.py::train_epoch",
}
# (JAX module, name) -> why the port needs none
NOT_NEEDED = {
    ("models/layers.py", "frozen_word_table"):
        "the word table is a frozen buffer (`word_vectors`) of each model",
    ("models/layers.py", "xavier_uniform"):
        "nn.init.xavier_uniform_ with a torch.Generator",
    ("ops/textcnn_pallas.py", "paired_operand"):
        "TPU layout: word pairs for the 128-lane paired kernel",
    ("ops/textcnn_pallas.py", "textcnn_pool_paired"):
        "TPU layout: the op on paired operands; the CUDA kernels read x",
    ("train/loop.py", "paired_window_for"):
        "TPU layout: when the doc cache stores paired operands",
    ("train/loop.py", "TrainState"):
        "pytree plumbing: the module and its optimizer hold the state",
    ("train/evaluate.py", "make_apply_fn"):
        "a jit-step factory: the port calls its modules eagerly",
    ("serve.py", "Recommender.compiled_variants"):
        "counts jit specialisations; the port compiles nothing per shape",
}


def _tree(path: Path) -> Optional[ast.Module]:
    return ast.parse(path.read_text()) if path.exists() else None


def _top_names(tree: ast.Module, imports: bool) -> Set[str]:
    """Names a module binds at its top level: functions, classes and
    assigned constants, and with `imports` the names it imports."""
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names


def _members(tree: ast.Module, cls: str) -> Optional[Set[str]]:
    """The public methods and properties of class `cls`, or None."""
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            return {n.name for n in node.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not n.name.startswith("_")}
    return None


def _public(names: Set[str]) -> Set[str]:
    return {n for n in names if not n.startswith("_")}


MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))
TABLE: Dict = {**COUNTERPART, **NOT_NEEDED}


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_a_counterpart(module):
    names = _public(_top_names(_tree(JAX / module), imports=False))
    port = _tree(PORT / MODULE_OF.get(module, module))
    assert port is not None or not names, \
        f"reviews4rec_torch has no {MODULE_OF.get(module, module)}"
    have = _top_names(port, imports=True) if port is not None else set()
    missing = sorted(n for n in names - have if (module, n) not in TABLE)
    assert not missing, f"{module}: no counterpart and no table entry " \
        f"for {missing}"


@pytest.mark.parametrize("module,cls", [(m, c) for m, cs in CLASSES.items()
                                        for c in cs])
def test_every_public_member_has_a_counterpart(module, cls):
    names = _members(_tree(JAX / module), cls)
    have = _members(_tree(PORT / module), cls)
    assert names is not None and have is not None, (module, cls)
    missing = sorted(n for n in names - have
                     if (module, f"{cls}.{n}") not in TABLE)
    assert not missing, f"{cls}: no counterpart and no table entry for " \
        f"{missing}"


@pytest.mark.parametrize("module,name", sorted(TABLE))
def test_table_entry_names_a_jax_name_without_a_namesake(module, name):
    """The JAX name exists, the port's module has no name of its own
    spelling (else the entry is not needed), and a counterpart exists."""
    cls, _, member = name.rpartition(".")
    jax_tree = _tree(JAX / module)
    port_tree = _tree(PORT / MODULE_OF.get(module, module))
    if cls:
        assert member in (_members(jax_tree, cls) or ()), name
        assert member not in (_members(port_tree, cls) or ()), name
    else:
        assert name in _top_names(jax_tree, imports=False), name
        assert name not in _top_names(port_tree, imports=True), name
    if (module, name) in COUNTERPART:
        where, _, target = COUNTERPART[(module, name)].partition("::")
        assert target in _top_names(_tree(PORT / where), imports=False), \
            COUNTERPART[(module, name)]
    else:
        assert NOT_NEEDED[(module, name)].strip()
