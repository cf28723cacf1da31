"""Static guards over the source tree.

1. No default-precision contractions. On a GPU, JAX's default float32
   matmul runs in TF32 (~3 decimal digits): an unqualified
   ``points @ rotmat.T`` then carries a coordinate error that flips pixel
   snaps wholesale, and default-precision displacement matmuls move the
   argmax. The CPU suite cannot catch a reintroduction (the CPU default is
   full f32), so the rule is enforced statically over every module of the
   package:

   * the bare ``@`` operator (ast.MatMult) is forbidden — use
     ``jnp.matmul(..., precision=...)``, or ``np.matmul`` in host code, so
     intent is explicit;
   * every ``jnp``/``jax``/``lax`` ``dot`` / ``matmul`` / ``einsum`` /
     ``tensordot`` call must pass a ``precision=`` keyword.

2. No TPU-only code in the package, ``tools/``, ``bench.py`` or
   ``chip_smoke.py``: no TPU Pallas imports, no interpret-mode defaults and
   no branch on the backend being a TPU.
"""

import ast
import glob
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PACKAGE_MODULES = sorted(
    os.path.relpath(f, REPO)
    for f in glob.glob(os.path.join(REPO, "bioem_tpu", "**", "*.py"), recursive=True)
)
SOURCES = PACKAGE_MODULES + sorted(
    os.path.relpath(f, REPO)
    for f in glob.glob(os.path.join(REPO, "tools", "*.py"))
) + ["bench.py", "chip_smoke.py"]

CONTRACTION_FUNCS = {"dot", "matmul", "einsum", "tensordot"}


def _parse(rel):
    with open(os.path.join(REPO, rel)) as f:
        src = f.read()
    return src, ast.parse(src, filename=rel)


def _contraction_calls_without_precision(tree):
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            bad.append((node.lineno, "bare @ operator"))
        if isinstance(node, ast.Call):
            func = node.func
            name = None
            if isinstance(func, ast.Attribute):
                name = func.attr
            elif isinstance(func, ast.Name):
                name = func.id
            if name in CONTRACTION_FUNCS:
                kws = {k.arg for k in node.keywords}
                if "precision" not in kws and not (kws & {None}):
                    # functools.partial(jnp.einsum, precision=hi) wrappers
                    # produce Name calls like ein(...) — those resolve to
                    # a partial carrying precision; only flag direct
                    # jnp/jax/lax attribute calls.
                    if isinstance(func, ast.Attribute) and isinstance(
                        func.value, ast.Name
                    ) and func.value.id in ("jnp", "jax", "lax"):
                        bad.append((node.lineno, f"{name}() without precision="))
    return bad


def _tpu_only_code(src, tree):
    bad = []
    for lineno, line in enumerate(src.splitlines(), 1):
        if re.search(r"pallas\.tpu|pltpu|libtpu|interpret\s*=", line):
            bad.append((lineno, line.strip()))
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare):
            for operand in [node.left, *node.comparators]:
                if (isinstance(operand, ast.Constant)
                        and str(operand.value).lower() == "tpu"):
                    bad.append((node.lineno, "comparison with 'tpu'"))
    return bad


@pytest.mark.parametrize("rel", PACKAGE_MODULES)
def test_no_default_precision_contractions(rel):
    _, tree = _parse(rel)
    bad = _contraction_calls_without_precision(tree)
    assert not bad, (
        f"{rel}: default-precision contraction(s) {bad} — on a GPU float32 "
        "matmuls default to TF32; pin precision=jax.lax.Precision.HIGHEST"
    )


@pytest.mark.parametrize("rel", SOURCES)
def test_no_tpu_only_code(rel):
    src, tree = _parse(rel)
    bad = _tpu_only_code(src, tree)
    assert not bad, f"{rel}: TPU-only code {bad}"


def test_lints_catch_violations():
    """Both guards flag what they exist to flag."""
    src = (
        "import jax.numpy as jnp\n"
        "a = x @ y\n"
        "b = jnp.einsum('ij,jk->ik', x, y)\n"
        "c = jnp.dot(x, y, precision=hi)\n"
        "if jax.default_backend() == 'tpu':\n"
        "    from jax.experimental.pallas import tpu as pltpu\n"
    )
    tree = ast.parse(src)
    assert [l for l, _ in _contraction_calls_without_precision(tree)] == [2, 3]
    assert [l for l, _ in _tpu_only_code(src, tree)] == [6, 5]
