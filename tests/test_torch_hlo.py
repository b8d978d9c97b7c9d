"""The port's HLO collective parser (``repro_torch.analysis.hlo``) against
the JAX package's (``repro.analysis.hlo``), on the CPU.

* ``parse_collectives`` gives the same collectives (kind, result bytes,
  group size, count) and ``collective_wire_bytes`` the same totals and
  per-kind breakdown, on ``tests/test_analysis.py``'s ``_HLO`` text at
  several default group sizes, and on the compiled HLO of a small
  sharded JAX step (a psum, an all-gather, a reduce-scatter, an
  all-to-all and a ``ppermute``) that a subprocess compiles on 8 forced
  host devices, so that the forced count never reaches this process;
* ``_shape_bytes`` and the ring formulas agree on hand-made inputs,
  every dtype of the table included.
"""
import ast
import os
import subprocess
import sys

import pytest

from repro.analysis import hlo as jhlo
from repro_torch import analysis
from repro_torch.analysis import hlo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _test_analysis_hlo() -> str:
    """``_HLO`` of ``tests/test_analysis.py``, read without importing it."""
    path = os.path.join(ROOT, "tests", "test_analysis.py")
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "_HLO"):
            return node.value.value
    raise AssertionError("tests/test_analysis.py has no _HLO")


_SCRIPT_8DEV = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P

mesh = jax.make_mesh((4, 2), ("data", "model"))


def body(x, w):
    s = jax.lax.psum(x @ w, "model")
    g = jax.lax.all_gather(s, "data", tiled=True)
    r = jax.lax.psum_scatter(g, "data", scatter_dimension=0, tiled=True)
    a = jax.lax.all_to_all(r.astype(jnp.bfloat16), "data", 1, 1, tiled=True)
    return jax.lax.ppermute(a, "data", [(i, (i + 1) % 4) for i in range(4)])


step = jax.jit(jax.shard_map(body, mesh=mesh,
                             in_specs=(P("data", "model"), P("model", None)),
                             out_specs=P("data", "model")))
x = jax.ShapeDtypeStruct((32, 16), jnp.float32)
w = jax.ShapeDtypeStruct((16, 8), jnp.bfloat16)
print(step.lower(x, w).compile().as_text())
"""


@pytest.fixture(scope="module")
def sharded_hlo() -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _SCRIPT_8DEV], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def _as_tuples(colls):
    return [(c.kind, c.result_bytes, c.group_size, c.count) for c in colls]


def _same_parse(text: str, default_group: int):
    got = hlo.parse_collectives(text, default_group)
    want = jhlo.parse_collectives(text, default_group)
    assert _as_tuples(got) == _as_tuples(want)
    assert hlo.collective_wire_bytes(got) == jhlo.collective_wire_bytes(want)
    return got


@pytest.mark.parametrize("default_group", [1, 8, 256])
def test_parse_equals_the_reference_on_the_analysis_text(default_group):
    got = _same_parse(_test_analysis_hlo(), default_group)
    assert {c.kind for c in got} == set(hlo._COLLECTIVES)


def test_parse_equals_the_reference_on_a_compiled_sharded_step(
        sharded_hlo):
    assert "device_count=8" not in os.environ.get("XLA_FLAGS", "")
    got = _same_parse(sharded_hlo, default_group=8)
    kinds = [c.kind for c in got]
    for kind in hlo._COLLECTIVES:
        assert kind in kinds, (kind, kinds)
    groups = {c.kind: c.group_size for c in got}
    assert groups["all-reduce"] == 2 and groups["all-gather"] == 4
    assert groups["reduce-scatter"] == 4
    assert groups["collective-permute"] == 2
    total, per_kind = hlo.collective_wire_bytes(got)
    assert total == pytest.approx(sum(per_kind.values())) and total > 0


def test_shape_bytes_and_ring_formulas_equal_the_reference():
    for text in ("f32[4,256]", "(bf16[8,128], s8[3])", "pred[]",
                 "u64[2,2] f64[3] token[] u16[7]",
                 " ".join(f"{dt}[3,5]" for dt in hlo._DTYPE_BYTES)):
        assert hlo._shape_bytes(text) == jhlo._shape_bytes(text), text
    colls = [(kind, s, p) for kind in hlo._COLLECTIVES
             for s in (1, 1000, 1 << 30) for p in (0, 1, 2, 16, 512)]
    got = hlo.collective_wire_bytes([hlo.Collective(*c) for c in colls])
    want = jhlo.collective_wire_bytes([jhlo.Collective(*c) for c in colls])
    assert got == want
    assert hlo.collective_wire_bytes([]) == (0.0, {})


def test_exported_from_the_analysis_package():
    assert analysis.parse_collectives is hlo.parse_collectives
    assert analysis.collective_wire_bytes is hlo.collective_wire_bytes
    assert analysis.Collective is hlo.Collective
    assert hlo.__all__ == jhlo.__all__
