"""The numpy-only modules that the port copies from the JAX package (so that
it runs where that package is absent) stay equal to their sources: every
top-level function, class method and assignment of a copy has the same
syntax tree as its namesake in the source, once the port's package name is
read as the JAX package's. The names in DIFFERS are the deliberate changes
that each copy's docstring states."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = ["data/tum.py", "data/replica.py", "data/synthetic.py",
          "mapstate/scene.py", "native/__init__.py", "pipeline/config.py",
          "metrics/ate.py", "geometry/np_se3.py", "vis/mesh.py",
          "utils/profiling.py"]
# copy -> top-level names that differ on purpose
DIFFERS = {
    "native/__init__.py": {"_BUILD", "_SO", "_build"},  # builds into _build/
    "vis/mesh.py": {"create_map_mesh"},  # faces_type="poisson" raises
    "utils/profiling.py": {"device_trace"},  # the JAX trace helper is left out
}


def _defs(path):
    """{name: ast dump} of the module's top-level functions, class methods
    (as Class.method) and assignments."""
    src = open(path).read().replace("bundleadjustment_tpu_torch", "bundleadjustment_tpu")
    out = {}
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = ast.dump(ast.ClassDef(
                name=node.name, bases=node.bases, keywords=node.keywords, body=[],
                decorator_list=node.decorator_list, type_params=[]))
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{item.name}"] = ast.dump(item)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out[" ".join(ast.unparse(t) for t in targets)] = ast.dump(node)
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_its_source(rel):
    got = _defs(os.path.join(REPO, "bundleadjustment_tpu_torch", rel))
    src = _defs(os.path.join(REPO, "bundleadjustment_tpu", rel))
    differs = DIFFERS.get(rel, set())
    assert got, rel
    for name, dump in got.items():
        if name.split(".")[0] in differs:
            continue
        assert name in src, f"{rel}: {name} is not in the source"
        assert dump == src[name], f"{rel}: {name} differs from the source"
    # class bodies may be shorter (PhaseTimer drops merge), top-level ones not
    missing = {n for n in src if "." not in n} - set(got) - differs
    assert not missing, f"{rel}: the copy lacks {sorted(missing)}"


def test_native_store_source_matches():
    """mapstore.cpp: equal line for line outside its comments."""
    def code(path):
        return [ln for ln in open(path).read().splitlines()
                if not ln.lstrip().startswith("//")]

    assert (code(os.path.join(REPO, "bundleadjustment_tpu_torch/native/mapstore.cpp"))
            == code(os.path.join(REPO, "bundleadjustment_tpu/native/mapstore.cpp")))
