"""The port's configs, cost model and weight conversion against the JAX
package's, on the CPU.

* every ``ARCHS`` entry and its ``reduced()`` equal to the reference's
  field for field, ``SHAPES``, ``LONG_CONTEXT_ARCHS``, ``get_config`` and
  ``cell_is_applicable`` the same;
* the model half of the cost model: ``cell_flops``, ``cell_costs``,
  ``active_params`` and ``model_flops`` equal for every arch x shape,
  ``cell_bytes`` at 16 and 512 chips, and both sides raising
  ``ZeroDivisionError`` at one chip (the reference divides the batch by
  ``chips // 16``);
* the parameter layout: every leaf of the reference's full-size
  ``param_shapes`` lands on a parameter of the port's model (built on the
  ``meta`` device) of the same shape and dtype, and nothing is left over;
* ``params_from_tree`` / ``params_to_tree`` and ``cache_from_tree`` /
  ``cache_to_tree`` round trips give equal arrays;
* one ``python -m repro_torch.launch.serve --device cpu`` run, and the
  entry points raising when there is no card and the CPU was not asked
  for.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.analysis import flops as jflops  # noqa: E402
from repro.analysis import roofline as jroofline  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.analysis import flops, roofline  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH_IDS = sorted(configs.ARCHS)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def test_registry_and_shapes_equal_the_reference():
    assert list(configs.ARCHS) == list(jconfigs.ARCHS)
    assert registry.LONG_CONTEXT_ARCHS == jregistry.LONG_CONTEXT_ARCHS
    assert ({k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()})
    for name in ARCH_IDS:
        assert configs.get_config(name) is configs.ARCHS[name]
        for shape in configs.SHAPES:
            assert (registry.cell_is_applicable(name, shape)
                    == jregistry.cell_is_applicable(name, shape))
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("name", ARCH_IDS)
def test_configs_equal_field_for_field(name):
    got, want = configs.ARCHS[name], jconfigs.ARCHS[name]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (dataclasses.asdict(got.reduced())
            == dataclasses.asdict(want.reduced()))
    assert (dataclasses.asdict(got.reduced(num_layers=8, dtype="bfloat16"))
            == dataclasses.asdict(want.reduced(num_layers=8,
                                               dtype="bfloat16")))
    for prop in ("vocab_padded", "ssm_d_inner", "ssm_heads",
                 "pattern_period", "num_periods", "is_enc_dec",
                 "has_attention"):
        assert getattr(got, prop) == getattr(want, prop), prop


@pytest.mark.parametrize("name", ARCH_IDS)
def test_cost_model_equals_the_reference(name):
    cfg, jcfg = configs.ARCHS[name], jconfigs.ARCHS[name]
    assert flops._count_params(cfg) == jflops._count_params(jcfg)
    assert roofline.active_params(cfg) == jroofline.active_params(jcfg)
    for shape_name, shape in configs.SHAPES.items():
        jshape = jconfigs.SHAPES[shape_name]
        assert flops.cell_flops(cfg, shape) == jflops.cell_flops(jcfg, jshape)
        for chips in (16, 512):
            assert (flops.cell_bytes(cfg, shape, chips)
                    == jflops.cell_bytes(jcfg, jshape, chips))
            assert (dataclasses.asdict(flops.cell_costs(cfg, shape, chips))
                    == dataclasses.asdict(jflops.cell_costs(jcfg, jshape,
                                                            chips)))
        with pytest.raises(ZeroDivisionError):
            jflops.cell_bytes(jcfg, jshape, 1)
        with pytest.raises(ZeroDivisionError):
            flops.cell_bytes(cfg, shape, 1)
        tokens = shape.global_batch * shape.seq_len
        assert (roofline.model_flops(cfg, tokens, shape.kind)
                == jroofline.model_flops(jcfg, tokens, shape.kind))


@pytest.mark.parametrize("name", ARCH_IDS)
def test_parameter_layout_matches_the_reference(name):
    """Every leaf of the full-size reference tree maps onto the port's
    parameters with its shape and dtype, one slice a layer."""
    cfg, jcfg = configs.ARCHS[name], jconfigs.ARCHS[name]
    shapes = jtfm.param_shapes(jcfg)
    model = tfm.Transformer(cfg, None, "meta")
    params = dict(model.named_parameters())
    seen = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        for key, i in convert._port_keys(cfg, keys):
            p = params[key]
            want = leaf.shape if i is None else leaf.shape[1:]
            assert tuple(p.shape) == tuple(want), key
            assert p.dtype == DTYPES[str(leaf.dtype)], key
            seen.add(key)
    assert seen == set(params)
    n = sum(p.numel() for p in params.values())
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "whisper-large-v3",
                                  "gemma2-9b"])
def test_tree_round_trips(name):
    cfg = configs.ARCHS[name].reduced()
    model = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tree = convert.params_to_tree(model)
    back = convert.params_to_tree(convert.params_from_tree(cfg, tree, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jtree = jtfm.param_shapes(cfg)
    assert (jax.tree.structure(jax.tree.map(lambda _: 0, jtree))
            == jax.tree.structure(jax.tree.map(lambda _: 0, tree)))

    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    m16 = tfm.init_params(torch.Generator().manual_seed(0), bf16, "cpu")
    t16 = convert.params_to_tree(m16)
    again = convert.params_from_tree(bf16, t16, "cpu")
    for (k, a), (_, b) in zip(m16.named_parameters(),
                              again.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), k

    rng = np.random.default_rng(0)
    cache = jax.tree.map(
        lambda a: (rng.integers(-127, 128, a.shape).astype(a.dtype)
                   if a.dtype == np.int8
                   else rng.normal(size=a.shape).astype(a.dtype)),
        jax.tree.map(np.asarray, jtfm.init_cache(cfg, 2, 24)))
    back = convert.cache_to_tree(cfg, convert.cache_from_tree(cfg, cache,
                                                              "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(cache)
    for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_serve_launcher_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "moonshot-v1-16b-a3b", "--gen", "4", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "generated (4, 5) tokens; prefill" in out.stdout
    assert "ms/token" in out.stdout


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no card and no request for the CPU, the entry points raise
    rather than carry on on the CPU."""
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.ARCHS["qwen2-1.5b"].reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfm.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfm.Transformer(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfm.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_tree(cfg, {}, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen2-1.5b"])
