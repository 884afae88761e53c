"""Nothing the benchmark holds imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import os
import sys

import pytest

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "yunet_tpu"}
REFERENCE_MAY = {"__future__", "contextlib", "math", "typing", "numpy",
                 "torch"}


def sources(sub=""):
    root = os.path.join(PB, sub)
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imports(path):
    """(top-level name, level) of every import in a file; a relative
    import has level > 0 and the name of its first part, if any."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def test_no_jax_anywhere():
    bad = [(os.path.relpath(p, PB), name) for p in sources()
           for name, level in imports(p)
           if level == 0 and name in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("path", list(sources("reference")),
                         ids=lambda p: os.path.basename(p))
def test_reference_imports_only_plain_libraries(path):
    for name, level in imports(path):
        if level:
            # its own siblings only: ``from .model import ...``
            assert level == 1 and name in ("model", "detect", "compare",
                                           ""), (path, name)
        else:
            assert name in REFERENCE_MAY, (path, name)


@pytest.mark.parametrize("probe, flagged", [
    ("jax.portbench_probe", "jax"), ("yunet_tpu.portbench_probe",
                                     "yunet_tpu"),
    ("yunet_tpu_torch.portbench_probe", None)])
def test_run_time_check_compares_whole_top_level_names(probe, flagged):
    from portbench import harness
    sys.modules[probe] = sys
    try:
        found = harness.forbidden_loaded()
    finally:
        del sys.modules[probe]
    assert "yunet_tpu_torch" not in found
    if flagged:
        assert flagged in found
