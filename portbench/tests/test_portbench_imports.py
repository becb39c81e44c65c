"""Nothing the benchmark runs imports JAX or the JAX package, and the
references import nothing of the port."""

import ast
import os

import pytest

from portbench.core import guard, load

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(load.PKG)
               for f in fs if f.endswith(".py"))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_the_scan_sees_files():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(f, load.PKG) for f in FILES])
def test_no_jax_and_no_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(guard.BANNED), (path, tops & set(guard.BANNED))


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(load.PKG, "reference")
    for path in FILES:
        if path.startswith(ref):
            tops = {n.split(".")[0] for n in _imports(path)}
            assert "vst_tpu_torch" not in tops, path


def test_the_runtime_guard_compares_whole_top_level_names():
    assert guard.banned_modules(["vst_tpu_torch", "vst_tpu_torch.models",
                                 "jaxtyping", "torch"]) == []
    assert guard.banned_modules(["vst_tpu.models.vgg", "jax._src",
                                 "flax"]) == ["flax", "jax", "vst_tpu"]
