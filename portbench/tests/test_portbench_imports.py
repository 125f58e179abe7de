"""Nothing under portbench/ imports JAX or the JAX package, or opens the
JAX bench's files. Module names are compared by their top-level name,
whole: `libyafaray_tpu_torch` is the program, `libyafaray_tpu` its JAX
counterpart."""
import ast
import os

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "libyafaray_tpu"}
# the JAX bench and its records (joined here so that this file does not
# name them itself)
FILES = ("bench" + ".py", "BENCH" + "_", "MULTICHIP" + "_",
         "BASELINE_MEASURED" + ".json")


def _sources():
    for dirpath, _, files in os.walk(PORTBENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_no_jax_import():
    bad = []
    for path in _sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for name in _imported(tree):
            if name.split(".")[0] in FORBIDDEN:
                bad.append((path, name))
    assert not bad


def test_the_program_passes_the_whole_name_check():
    assert "libyafaray_tpu_torch".split(".")[0] not in FORBIDDEN


def test_no_jax_bench_file_is_opened():
    """No string in the code names the JAX bench or its records (the
    configurations' `source` texts cite bench.py's lines as the origin of
    a scene, and are data, not a path the code opens)."""
    bad = []
    for path in _sources():
        if os.path.abspath(path) == os.path.abspath(__file__):
            continue
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                for arg in node.args:
                    if isinstance(arg, ast.Constant) and isinstance(
                            arg.value, str) and any(
                                f in arg.value for f in FILES):
                        bad.append((path, arg.value))
    assert not bad
