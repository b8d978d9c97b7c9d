"""The port's sharding rules, hints and meshes (``repro_torch.models.
{sharding,pshard}``, ``repro_torch.launch.mesh``,
``transformer.param_shapes``) against the JAX package's, on the CPU.

* ``param_shapes`` equals the JAX ``param_shapes`` (shapes, dtypes, tree
  keys) for all ten archs at full size, allocating nothing;
* every parameter spec equals ``tuple(spec)`` of the JAX
  ``param_shardings`` on ``jax.make_mesh((1, 1), ("data", "model"))``
  and on ``AbstractMesh`` (16, 16) and (2, 16, 16), which reach the
  divisibility branches (EP against TP);
* ``input_specs`` (batch, cache, token, pos, step and opt_state stand-ins
  and specs) equals the JAX one for every applicable arch x shape on
  both production meshes (``kv_on_heads``, the cache's sequence axis);
* ``bytes_per_device`` rounds each sharded dimension up and, on a
  (1, 1) mesh, gives every byte of the model;
* the hints leave ``forward_hidden``, prefill, decode and one train
  step unchanged bit for bit with and without a (1, 1) mesh set, sit
  where the reference puts them, and raise on an unknown axis, a doubled
  axis and a spec longer than the tensor's rank;
* the meshes: the production meshes refuse a host with too few devices
  and build over placeholder devices; ``make_host_mesh``.

The JAX side's ``param_shapes`` (an ``eval_shape`` of the full-size
init) is cached per arch for the module, and patched into the JAX
``input_specs`` while it runs.
"""
import dataclasses
import math
from unittest import mock

import jax
import pytest
from jax.sharding import AbstractMesh

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JAX_ARCHS, SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs.registry import cell_is_applicable  # noqa: E402
from repro.models import sharding as jsharding  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import parity, pshard, sharding  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

ARCH_IDS = sorted(ARCHS)
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the parallel suite runs a whole
    file in one worker, and the other workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_JAX_SHAPES: dict = {}
_JAX_PARAM_SHAPES = jtfm.param_shapes   # unpatched, for the cache below


def _jax_param_shapes(cfg):
    if cfg.name not in _JAX_SHAPES:
        _JAX_SHAPES[cfg.name] = _JAX_PARAM_SHAPES(cfg)
    return _JAX_SHAPES[cfg.name]


def _jax_mesh(name):
    shape, axes = MESHES[name]
    if name == "1x1":
        return jax.make_mesh(shape, axes)
    return AbstractMesh(shape, axes)


def _port_mesh(name):
    shape, axes = MESHES[name]
    return mesh_mod.Mesh(shape, axes,
                         mesh_mod.placeholder_devices(math.prod(shape)))


def _jax_items(tree):
    """(path tuple, leaf) of a JAX tree, paths as the port's: dict keys
    and sequence indices."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)] = \
            leaf
    return out


def _same_structs(got, want, what):
    """Port stand-ins (meta tensors) equal to JAX ``ShapeDtypeStruct``s:
    the same leaves under the same keys, in the same order."""
    want = _jax_items(want)
    got = dict(sharding._tree_items(got))
    assert list(got) == list(want), what
    for path, leaf in got.items():
        assert leaf.device.type == "meta", (what, path)
        assert tuple(leaf.shape) == tuple(want[path].shape), (what, path)
        assert str(leaf.dtype).removeprefix("torch.") == str(
            want[path].dtype), (what, path)


def _same_specs(structs, specs, want_shardings, what):
    want = _jax_items(want_shardings)
    got = {path: spec for path, _, spec in
           sharding.leaves_with_specs(structs, specs)}
    assert list(got) == list(want), what
    for path, spec in got.items():
        assert isinstance(spec, tuple), (what, path, spec)
        assert spec == tuple(want[path].spec), (what, path, spec,
                                                 want[path].spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shapes_equal_the_reference(arch):
    got = tfm.param_shapes(ARCHS[arch])
    _same_structs(got, _jax_param_shapes(JAX_ARCHS[arch]), arch)
    assert "param_shapes" in tfm.__all__ and "param_shapes" in jtfm.__all__


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh):
    cfg = ARCHS[arch]
    structs = tfm.param_shapes(cfg)
    jshapes = _jax_param_shapes(JAX_ARCHS[arch])
    want = jsharding.param_shardings(JAX_ARCHS[arch], _jax_mesh(mesh),
                                     jshapes)
    specs = sharding.param_shardings(cfg, _port_mesh(mesh), structs)
    _same_specs(structs, specs, want, (arch, mesh))
    opt = sharding.opt_shardings(cfg, _port_mesh(mesh), structs)
    assert opt["m"] == specs and opt["v"] == specs and opt["count"] == ()


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch, mesh):
    """Every input of every applicable cell of ``arch``: stand-ins and
    specs, on a production mesh."""
    jm, pm = _jax_mesh(mesh), _port_mesh(mesh)
    with mock.patch.object(jsharding.tfm, "param_shapes",
                           _jax_param_shapes):
        for shape in SHAPES:
            if not cell_is_applicable(arch, shape)[0]:
                continue
            want = jsharding.input_specs(JAX_ARCHS[arch], JAX_SHAPES[shape],
                                         jm)
            got = sharding.input_specs(ARCHS[arch], SHAPES[shape], pm)
            assert set(got) == set(want), (arch, shape)
            for key, (w_structs, w_shardings) in want.items():
                g_structs, g_specs = got[key]
                _same_structs(g_structs, w_structs, (arch, shape, key))
                _same_specs(g_structs, g_specs, w_shardings,
                            (arch, shape, key))


def test_batch_axes_and_spec_normal_form():
    assert sharding.batch_axes(_port_mesh("16x16")) == ("data",)
    assert sharding.batch_axes(_port_mesh("2x16x16")) == ("pod", "data")
    assert sharding.P(("data",), None) == ("data", None)
    assert sharding.P((), "model") == (None, "model")
    assert sharding.P(("pod", "data")) == (("pod", "data"),)
    assert "train_arg_shardings" in jsharding.__all__
    assert not hasattr(jsharding, "train_arg_shardings")
    assert "train_arg_shardings" not in sharding.__all__
    for name in sharding.__all__:
        assert hasattr(sharding, name), name


def test_bytes_per_device_rounds_up_and_counts_the_model():
    mesh = _port_mesh("2x16x16")
    leaf = torch.empty((3, 50, 7), dtype=torch.bfloat16, device="meta")
    # 50 over pod x data = 32 -> 2 rows; 7 over model = 16 -> 1
    assert sharding.bytes_per_device(
        leaf, (None, ("pod", "data"), "model"), mesh) == 3 * 2 * 1 * 2
    assert sharding.bytes_per_device(leaf, (None,), mesh) == 3 * 50 * 7 * 2
    cfg = ARCHS["moonshot-v1-16b-a3b"]
    structs = tfm.param_shapes(cfg)
    one = _port_mesh("1x1")
    model = tfm.Transformer(cfg, None, "meta")
    assert sharding.bytes_per_device(
        structs, sharding.param_shardings(cfg, one, structs), one) == sum(
            p.numel() * p.element_size() for p in model.parameters())


def test_cache_shapes_match_the_port_cache():
    """The stacked meta cache holds the port's per-layer cache, period
    by period (``models.convert``'s layout)."""
    for arch in ("gemma2-9b", "jamba-v0.1-52b", "whisper-large-v3"):
        cfg = ARCHS[arch].reduced()
        cache = tfm.init_cache(cfg, 2, 40, "cpu")
        tree = sharding.cache_shapes(cfg, 2, 40)
        period = cfg.pattern_period
        for l, entry in enumerate(cache["blocks"]):
            for name, t in entry.items():
                s = tree["blocks"][l % period][name]
                assert s.device.type == "meta"
                assert tuple(s.shape) == (cfg.num_periods, *t.shape)
                assert s.dtype == t.dtype
        assert ("cross" in tree) == cfg.is_enc_dec


# ----------------------------------------------------------------- hints
@pytest.fixture
def no_mesh():
    pshard.clear_mesh()
    yield
    pshard.clear_mesh()


class _deterministic:
    """Deterministic algorithms inside, as the card phase runs."""

    def __enter__(self):
        self.was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self.was)


def _cpu_mesh(shape=(1, 1), axes=("data", "model")):
    return mesh_mod.Mesh(shape, axes, (torch.device("cpu"),) * math.prod(
        shape))


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen2-1.5b",
                                  "jamba-v0.1-52b", "whisper-large-v3"])
def test_hints_change_nothing_on_a_one_device_mesh(arch, no_mesh):
    """Prefill logits, three decode steps and one train step, bit for bit
    with and without a (1, 1) mesh set; the mesh is cleared after."""
    cfg = ARCHS[arch].reduced()
    with _deterministic():
        plain = parity.mesh_runs(cfg, "cpu", None)
        hinted = parity.mesh_runs(cfg, "cpu", _cpu_mesh())
    assert parity.mesh_mismatches(plain, hinted) == []
    assert len(plain["logits"]) == 4
    assert pshard._MESH is None


def test_hints_sit_at_the_reference_call_sites(no_mesh):
    """forward_hidden: one "btd" on the embedded input; prefill: that one
    and one after each block; decode: none; the chunked loss: one "btv"
    a chunk. A hint with a mesh set returns its input itself."""
    from repro_torch.models import steps

    cfg = dataclasses.replace(ARCHS["qwen2-1.5b"].reduced(), ce_chunk=8)
    model = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    calls, hint = [], pshard.hint

    def counting(x, kind):
        out = hint(x, kind)
        assert out is x
        calls.append(kind)
        return out

    pshard.set_mesh(_cpu_mesh(), ("data",))
    with mock.patch.object(pshard, "hint", counting), torch.no_grad():
        tfm.forward_hidden(model, cfg, toks)
        assert calls == ["btd"]
        calls.clear()
        cache = tfm.init_cache(cfg, 2, 32, "cpu")
        tfm.prefill(model, cfg, toks, cache)
        assert calls == ["btd"] * (1 + cfg.num_layers)
        calls.clear()
        tfm.decode_step(model, cfg, toks[:, :1], cache, 24)
        assert calls == []
        hidden, _ = tfm.forward_hidden(model, cfg, toks)
        calls.clear()
        steps.chunked_ce_loss(model, cfg, hidden, toks, torch.ones(2, 24))
        assert calls == ["btv"] * 3


def test_hints_check_their_spec(no_mesh):
    x = torch.zeros(2, 3, 4)
    assert pshard.hint(x, "btd") is x          # no mesh: the identity
    assert pshard.hint_moe_dispatch(x, 4) is x
    assert pshard.num_batch_shards() == 1
    pshard.set_mesh(_cpu_mesh((1,), ("data",)), ("data",))
    assert pshard.hint(x, "btd") is x
    with pytest.raises(ValueError, match="not in the mesh"):
        pshard.hint(x, "btv")                   # no "model" axis
    pshard.set_mesh(_cpu_mesh(), ("data",))
    assert pshard.hint(x, "btv") is x
    with pytest.raises(ValueError, match="rank"):
        pshard.hint(torch.zeros(2, 3), "btd")
    with pytest.raises(ValueError, match="rank"):
        pshard.hint(x, "bthd")
    pshard.set_mesh(_cpu_mesh(), ("data",), ("data",))
    with pytest.raises(ValueError, match="twice"):
        pshard.hint(x, "btd")
    pshard.set_mesh(_cpu_mesh(), ("nope",))
    with pytest.raises(ValueError, match="not in the mesh"):
        pshard.hint(x, "btd")
    big = mesh_mod.Mesh((2, 4, 16), ("pod", "data", "model"),
                        mesh_mod.placeholder_devices(128))
    pshard.set_mesh(big, ("pod", "data"))
    assert pshard.num_batch_shards() == 8
    y = torch.zeros(8, 64, 5, 3)
    assert pshard.hint_moe_dispatch(y, 64) is y
    assert pshard.hint_moe_dispatch(y, 6) is y  # GSPMD pads: not checked
    pshard.set_mesh(big, ())
    assert pshard.num_batch_shards() == 1
    assert pshard.hint_moe_dispatch(y, 64) is y
    pshard.clear_mesh()
    assert pshard._MESH is None and pshard.num_batch_shards() == 1


# ----------------------------------------------------------------- meshes
def test_production_meshes():
    for multi, shape, axes in ((False, (16, 16), ("data", "model")),
                               (True, (2, 16, 16), ("pod", "data",
                                                    "model"))):
        n = math.prod(shape)
        with pytest.raises(RuntimeError, match=f"needs {n} devices, have 1"):
            mesh_mod.make_production_mesh(
                multi_pod=multi, devices=[torch.device("cpu")])
        m = mesh_mod.make_production_mesh(
            multi_pod=multi, devices=mesh_mod.placeholder_devices(600))
        assert m.axis_names == axes and m.axis_sizes == shape
        assert list(m.shape.items()) == list(zip(axes, shape))
        assert m.size == n and all(d.type == "meta" for d in m.devices)
    with pytest.raises(RuntimeError, match="placeholder"):
        mesh_mod.make_production_mesh(devices=[])
    with pytest.raises(ValueError):
        mesh_mod.Mesh((2, 2), ("data", "model"),
                      mesh_mod.placeholder_devices(3))


def test_host_mesh_and_defaults():
    devices = mesh_mod.local_devices()
    if not torch.cuda.is_available():
        assert devices == (torch.device("cpu"),)
        with pytest.raises(RuntimeError, match="have 1"):
            mesh_mod.make_production_mesh()
    m = mesh_mod.make_host_mesh()
    assert m.axis_names == ("data",) and m.shape == {"data": len(devices)}
    assert mesh_mod.make_host_mesh(1, axis="model").shape == {"model": 1}
    with pytest.raises(RuntimeError):
        mesh_mod.make_host_mesh(len(devices) + 1)
    assert sharding.batch_axes(m) == ("data",)
