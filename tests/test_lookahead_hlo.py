"""Compiled-module verification of the root-front depth-1 lookahead.

Both collective root-front schemes claim their step-k+1 panel/tile
broadcast is issued BEFORE the step's trailing matmul so XLA's async
collectives can hide the transfer behind the dominant compute
(dist_cholesky.py docstrings; this VERIFIES it rather than asserting it). The enabling property is structural: inside
the factorization loop, the lookahead collective must have NO data
dependence on the trailing update — otherwise no scheduler could overlap
them. These tests lower the real programs for the 8-virtual-device mesh
and walk the while-body SSA graph of the stablehlo module: the in-body
`all_reduce` that produces the next panel/tile must not transitively
depend on the step's big trailing `dot_general`.

(The async split into all-reduce-start/done happens in
the backend compiler; dependence freedom in the lowered module is the
backend-independent part and is what the docstrings' claim rests on.
tools/check_lookahead.py additionally inspects a real compile for the
start-before-dot schedule on a multi-device accelerator.)
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cholesky_tpu

cholesky_tpu.force_cpu()

from cholesky_tpu.parallel import dist_cholesky as dc   # noqa: E402
from cholesky_tpu.parallel.mesh import make_mesh        # noqa: E402


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8
    return make_mesh(8)


def _while_body(txt: str) -> str:
    """The (single) stablehlo.while's `do { ... }` region."""
    i = txt.index("stablehlo.while")
    j = txt.index(" do {", i)
    depth = 0
    for k in range(j + 4, len(txt)):
        if txt[k] == "{":
            depth += 1
        elif txt[k] == "}":
            depth -= 1
            if depth == 0:
                return txt[j:k]
    raise AssertionError("unterminated while body")


_DEF_RE = re.compile(r"^\s*(%[\w#]+)(?::\d+)? = (.*)$")


def _ssa_graph(body: str):
    """name -> (op, operand names) from each defining line. Ops print
    either bare (`stablehlo.dot_general %a, %b ...`) or quoted-call form
    (`"stablehlo.all_reduce"(%a) <{...}> ({ region`); operands are every
    %name on the defining line (reducer regions span later lines and
    reference only their own block args, so the line-local scan is the
    true operand set)."""
    graph = {}
    for line in body.splitlines():
        m = _DEF_RE.match(line)
        if not m:
            continue
        name, rest = m.groups()
        op = rest.split("(")[0].split(" ")[0].strip('"')
        ops = [o for o in re.findall(r"%[\w#]+", rest) if o != name]
        graph[name] = (op, ops)
    return graph


def _transitive(graph, name, seen=None):
    seen = set() if seen is None else seen
    if name in seen or name not in graph:
        return seen
    seen.add(name)
    for o in graph[name][1]:
        _transitive(graph, o, seen)
    return seen


def _check_lookahead(txt: str, big_dot_shape: str):
    body = _while_body(txt)
    graph = _ssa_graph(body)
    big_dots = []
    collectives = []
    for line in body.splitlines():
        m = _DEF_RE.match(line)
        if not m:
            continue
        name, rest = m.groups()
        op = rest.split("(")[0].split(" ")[0].strip('"')
        if "dot_general" in op and f"tensor<{big_dot_shape}>" in line.split(
                "->")[-1]:
            big_dots.append(name)
        if "all_reduce" in op:
            collectives.append(name)
    assert big_dots, f"no trailing dot of shape {big_dot_shape} in body"
    assert collectives, "no all_reduce in the loop body"
    for coll in collectives:
        deps = _transitive(graph, coll)
        for bd in big_dots:
            assert bd not in deps, (
                f"lookahead collective {coll} depends on trailing dot {bd}"
                " — the broadcast could never overlap the update")


def test_1d_lookahead_independent_of_trailing_update(mesh):
    """1-D column-cyclic scheme (distributed_cholesky): the step-k+1
    panel all_reduce [Fp, block] must not depend on the trailing update
    dot [Fp, cols_per_dev]. Fp=4096, ndev=8, block=256 keeps the two
    shapes distinct (cols_per_dev=512)."""
    fn = jax.jit(lambda a: dc.distributed_cholesky(a, mesh, block=256))
    txt = fn.lower(jax.ShapeDtypeStruct((4096, 4096), jnp.float32)).as_text()
    _check_lookahead(txt, "4096x512xf32")


def test_2d_lookahead_independent_of_trailing_update(mesh):
    """2-D block-cyclic scheme (distributed_cholesky_2d): the step-k+1
    diagonal-tile all_reduce [block, block] must not depend on the
    trailing update dot [Fr, Fc] = [1024, 2048] on the (4, 2) grid."""
    fn = jax.jit(lambda a: dc.distributed_cholesky_2d(a, mesh, block=256))
    txt = fn.lower(jax.ShapeDtypeStruct((4096, 4096), jnp.float32)).as_text()
    _check_lookahead(txt, "1024x2048xf32")
