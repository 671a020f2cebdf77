"""Nothing that `bench/run.py` imports is JAX or the JAX package, and the
reference imports nothing of the program.  Top-level names are compared
whole: the port's name, ``repro_torch``, begins with the JAX package's."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: pathlib.Path):
    """(top-level name, dotted module) of every import in ``path``,
    relative imports resolved against the bench package."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], a.name
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                mod = "bench." + mod if mod else "bench"
            yield mod.split(".")[0], mod
            if mod in ("bench", "bench.reference"):
                for a in node.names:
                    yield "bench", f"{mod}.{a.name}"


def _file(module: str):
    parts = module.split(".")[1:]
    p = BENCH.joinpath(*parts)
    for cand in (p.with_suffix(".py"), p / "__init__.py"):
        if cand.exists():
            return cand
    return None


def _closure(*start: pathlib.Path) -> dict:
    """Every bench module reachable from ``start``, with its imports."""
    todo = list(start)
    seen = {}
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen[f] = list(_imports(f))
        for top, mod in seen[f]:
            if top == "bench" and _file(mod) is not None:
                todo.append(_file(mod))
    return seen


def test_run_imports_no_jax_nor_the_jax_package():
    # the metric readers too, which `bench.spec` loads by name
    closure = _closure(BENCH / "run.py",
                       *sorted((BENCH / "metrics").glob("*.py")))
    found = {(f.name, mod) for f, imps in closure.items()
             for top, mod in imps if top in FORBIDDEN}
    assert not found
    assert BENCH / "harness.py" in closure
    assert BENCH / "reference" / "dense.py" in closure


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {top for imps in _closure(path).values() for top, _ in imps}
    assert not tops & (FORBIDDEN | {"repro_torch"})


def test_the_check_catches_a_forbidden_name():
    src = "import jax.numpy\nfrom repro.models import x\nimport repro_torch\n"
    tops = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add(node.module.split(".")[0])
    assert tops & FORBIDDEN == {"jax", "repro"}
