"""The port's public surface against the reference's, read from both
packages' sources with ``ast``: neither package is imported, nor JAX.

A public name of a module is a module-level function, class or assigned
name not starting with ``_``, a public method of such a class (``Class.
method``), and, in a package's ``__init__.py``, each entry of ``__all__``.
Its counterpart is the same name at the same module path of
``gorse_tpu_torch/``: defined or assigned there (a method also on a base
class of that module), imported into it, or listed in its ``__all__``.
Every reference name has one, or stands in ``NOT_PORTED`` with its reason;
an entry there that the port has, or that the reference no longer has,
fails too."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "gorse_tpu", ROOT / "gorse_tpu_torch"

_JAX = ("JAX sharding placement: the port's parallel.Mesh (a list of shards) and "
        "Replicas place tensors on the shards' devices")
_TPU = ("the TPU's 128-lane item packing and its VMEM budget; the port sizes its "
        "kernels itself (ROADMAP, 'TPU tuning constants')")
_FUSED = ("the port's make_sharded_bpr_epoch runs K3 for both of the reference's "
          "sharded epochs, the plain and the fused")

# (module path, name; None for the whole module) -> why the port has none
NOT_PORTED = {
    ("models/oracle.py", None): "a test oracle, not a path of the system: "
                                "tests/test_torch_als.py uses the reference's copy",
    ("protocol/gorse_tpu_pb2.py", None): "protoc's generated code: the port's "
                                         "protocol/pb.py writes the same bytes "
                                         "(tests/test_torch_grpc.py)",
    ("parallel/mesh.py", "mf_shardings"): _JAX,
    ("parallel/mesh.py", "put_sharded"): _JAX,
    ("parallel/mesh.py", "DATA_AXIS"): _JAX + "; the mesh has no named axes",
    ("parallel/mesh.py", "MODEL_AXIS"): _JAX + "; the mesh has no named axes",
    ("parallel/sharded.py", "place_global"): _JAX,
    ("parallel/sharded.py", "replicate"): _JAX,
    ("parallel/__init__.py", "mf_shardings"): _JAX,
    ("parallel/sharded.py", "make_sharded_bpr_epoch_fused"): _FUSED,
    ("parallel/__init__.py", "make_sharded_bpr_epoch_fused"): _FUSED,
    ("ops/bpr_kernel.py", "pack_items"): _TPU,
    ("ops/bpr_kernel.py", "unpack_items"): _TPU,
    ("ops/bpr_kernel.py", "epoch_resident_vmem_bytes"): _TPU,
    ("ops/bpr_kernel.py", "fits_epoch_resident"): _TPU,
    ("ops/bpr_kernel.py", "LANES"): _TPU,
}


def _methods(cls: ast.ClassDef) -> set[str]:
    return {n.name for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and not n.name.startswith("_")}


def _assigned(node) -> list[str]:
    targets = (node.targets if isinstance(node, ast.Assign)
               else [node.target] if isinstance(node, ast.AnnAssign) else [])
    return [t.id for t in targets if isinstance(t, ast.Name)]


def _all(tree: ast.Module) -> set[str]:
    for node in tree.body:
        if "__all__" in _assigned(node):
            return {e.value for e in node.value.elts if isinstance(e, ast.Constant)}
    return set()


def public_names(tree: ast.Module) -> set[str]:
    """A reference module's public names."""
    names = set(_all(tree))
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not node.name.startswith("_"):
                names.add(node.name)
                if isinstance(node, ast.ClassDef):
                    names |= {f"{node.name}.{m}" for m in _methods(node)}
        else:
            names |= {n for n in _assigned(node) if not n.startswith("_")}
    return names


def bound_names(tree: ast.Module) -> set[str]:
    """Every name a port module offers: defined, assigned, imported or in
    ``__all__``, and each class's methods with those of its bases in the
    same module."""
    names = set(_all(tree))
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        else:
            names |= set(_assigned(node))
    for name, cls in classes.items():
        todo, seen = [cls], set()
        while todo:
            c = todo.pop()
            if c.name in seen:
                continue
            seen.add(c.name)
            names |= {f"{name}.{m}" for m in _methods(c)}
            todo += [classes[b.id] for b in c.bases if isinstance(b, ast.Name) and b.id in classes]
    return names


def _read(root: Path, fn) -> dict[str, set[str]]:
    return {p.relative_to(root).as_posix(): fn(ast.parse(p.read_text()))
            for p in sorted(root.rglob("*.py"))}


@pytest.fixture(scope="module")
def surfaces():
    return _read(REF, public_names), _read(PORT, bound_names)


def missing(ref: dict, port: dict, not_ported: dict) -> list[tuple[str, str | None]]:
    """Reference names (or whole modules) without a counterpart that
    ``not_ported`` does not name."""
    out = []
    for module, names in ref.items():
        if module not in port:
            if (module, None) not in not_ported:
                out.append((module, None))
            continue
        out += [(module, n) for n in sorted(names - port[module]) if (module, n) not in not_ported]
    return out


def stale(ref: dict, port: dict, not_ported: dict) -> list[tuple[str, str | None]]:
    """Entries of ``not_ported`` that the port has, or the reference no
    longer has."""
    out = []
    for module, name in not_ported:
        if name is None:
            gone, ported = module not in ref, module in port
        else:
            gone = name not in ref.get(module, set())
            ported = name in port.get(module, set())
        if gone or ported:
            out.append((module, name))
    return out


def test_every_reference_module_has_its_port_module(surfaces):
    ref, port = surfaces
    assert len(ref) > 90
    assert [m for m in missing(ref, port, NOT_PORTED) if m[1] is None] == []


def test_every_public_name_has_its_counterpart(surfaces):
    ref, port = surfaces
    assert sum(map(len, ref.values())) > 1000
    assert [m for m in missing(ref, port, NOT_PORTED) if m[1] is not None] == []


def test_every_exception_is_still_needed_and_has_a_reason(surfaces):
    ref, port = surfaces
    assert stale(ref, port, NOT_PORTED) == []
    assert all(len(reason) > 40 for reason in NOT_PORTED.values())


@pytest.mark.parametrize("case", ["name taken out", "module taken out", "exception ported",
                                  "exception gone from the reference"])
def test_the_check_fails_when_the_surfaces_part(surfaces, case):
    """The comparison on altered copies of the two surfaces: a reference
    name or module taken out of the port is missing; an exception for a
    name the port has, or the reference lacks, is stale."""
    ref, port = ({m: set(n) for m, n in s.items()} for s in surfaces)
    not_ported = dict(NOT_PORTED)
    if case == "name taken out":
        port["data/loaders.py"].discard("synthetic_cf_powerlaw")
        assert ("data/loaders.py", "synthetic_cf_powerlaw") in missing(ref, port, not_ported)
    elif case == "module taken out":
        del port["serve/metrics.py"]
        assert ("serve/metrics.py", None) in missing(ref, port, not_ported)
    elif case == "exception ported":
        port["ops/bpr_kernel.py"].add("pack_items")
        assert ("ops/bpr_kernel.py", "pack_items") in stale(ref, port, not_ported)
    else:
        not_ported[("models/base.py", "evaluate_models")] = "a name the reference never had"
        assert ("models/base.py", "evaluate_models") in stale(ref, port, not_ported)


def test_the_names_of_this_slice_are_held():
    """The reference's last names before this check existed, each found in
    the port at its module path."""
    port = _read(PORT, bound_names)
    for module, name in (("data/loaders.py", "synthetic_cf_powerlaw"),
                         ("data/dataset.py", "Dataset.edge_arrays"),
                         ("data/dataset.py", "Dataset.split_latest"),
                         ("models/base.py", "evaluate_model"),
                         ("models/base.py", "MatrixFactorization.is_fitted"),
                         ("models/base.py", "Score.to_dict"),
                         ("serve/metrics.py", "OnlineEvaluator.add"),
                         ("serve/metrics.py", "OnlineEvaluator.evaluate"),
                         ("storage/types.py", "now"),
                         ("models/__init__.py", "evaluate_model"),
                         ("data/__init__.py", "synthetic_cf_powerlaw")):
        assert name in port[module], (module, name)
