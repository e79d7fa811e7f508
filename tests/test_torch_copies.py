"""The numpy-only modules that the port copies from the JAX package (so that
it runs where that package is absent) stay equal to their sources: every
top-level function, class method and assignment of a copy has the same
syntax tree as its namesake in the source, once the port's package name is
read as the JAX package's. The names in DIFFERS are the deliberate changes
that each copy's docstring states; those in DEVICE_ARG equal their source
once their `device` parameter (and the keyword that passes it on) is taken
out. PARTIAL lists the host functions that device modules of the port copy
from their sources."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = ["data/tum.py", "data/replica.py", "data/synthetic.py",
          "mapstate/scene.py", "native/__init__.py", "pipeline/config.py",
          "metrics/ate.py", "geometry/np_se3.py", "vis/mesh.py",
          "utils/profiling.py", "vis/live.py", "vis/debug.py"]
# copy -> top-level names that differ on purpose
DIFFERS = {
    "native/__init__.py": {"_BUILD", "_SO", "_build"},  # builds into _build/
    "utils/profiling.py": {"device_trace"},  # torch.profiler in place of jax's
}
# copy -> functions that take a `device` and pass it on (Poisson on the card)
DEVICE_ARG = {"vis/mesh.py": {"create_map_mesh"}}
# device module of the port -> the host functions it copies from its source
PARTIAL = {"vis/poisson.py": ["_to_unit_cube", "surface_nets"],
           "metrics/reconstruction.py": ["percentile_scale", "normalize_cloud"],
           "utils/flops.py": ["FLOP_MODEL_VERSION", "dense_ba_iter_flops",
                              "dense_ba_iter_bytes", "_frontend_level_dims",
                              "_frontend_level_allocs", "frontend_flops"],
           "utils/marginal.py": ["fit_line", "measure_marginal"]}


class _DropDevice(ast.NodeTransformer):
    """Take the `device` parameter (with its default) and every `device=`
    keyword out of a function."""

    def visit_FunctionDef(self, node):
        args = node.args
        names = [a.arg for a in args.args]
        if "device" in names:
            i = names.index("device")
            d = i - (len(args.args) - len(args.defaults))
            del args.args[i]
            if d >= 0:
                del args.defaults[d]
        self.generic_visit(node)
        return node

    def visit_Call(self, node):
        node.keywords = [k for k in node.keywords if k.arg != "device"]
        self.generic_visit(node)
        return node


def _defs(path, drop_device=()):
    """{name: ast dump} of the module's top-level functions, class methods
    (as Class.method) and assignments; the functions named in
    `drop_device` without their `device` argument."""
    src = open(path).read().replace("bundleadjustment_tpu_torch", "bundleadjustment_tpu")
    out = {}
    for node in ast.parse(src).body:
        if getattr(node, "name", None) in drop_device:
            node = _DropDevice().visit(node)
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
    got = _defs(os.path.join(REPO, "bundleadjustment_tpu_torch", rel),
                DEVICE_ARG.get(rel, ()))
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


@pytest.mark.parametrize("rel", list(PARTIAL))
def test_host_functions_match_their_source(rel):
    got = _defs(os.path.join(REPO, "bundleadjustment_tpu_torch", rel))
    src = _defs(os.path.join(REPO, "bundleadjustment_tpu", rel))
    for name in PARTIAL[rel]:
        assert got[name] == src[name], f"{rel}: {name} differs from the source"


def test_native_store_source_matches():
    """mapstore.cpp: equal line for line outside its comments."""
    def code(path):
        return [ln for ln in open(path).read().splitlines()
                if not ln.lstrip().startswith("//")]

    assert (code(os.path.join(REPO, "bundleadjustment_tpu_torch/native/mapstore.cpp"))
            == code(os.path.join(REPO, "bundleadjustment_tpu/native/mapstore.cpp")))
