"""The port's model layers (``repro_torch.models``) against the JAX
package's on the CPU, in float32 on the same numpy inputs: rmsnorm, rope,
softcap and swiglu; ``quantize_kv`` (int8 values equal, scales at rtol
1e-6, also in bfloat16); ``attention_core`` with blocks smaller than the
sequence (padding, the causal mask, the window, the score softcap, GQA,
and the reference's non-causal padding, where padded keys take part);
``_ssd_chunked`` with and without an entering state; and
``_moe_tokens``: expert ids equal exactly (ties to the lower index, as
``jax.lax.top_k``), capacity ranks and the keep mask equal, and the
output at rtol 1e-5, with and without capacity drops.

Floats are held at rtol 1e-5 and atol 1e-6 (atol 1e-5 where sums of
terms up to ~30 in size cancel: swiglu, the SSD scan); ids, ranks,
masks and int8 values are held exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import attention, layers, moe, ssm  # noqa: E402

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the parallel suite runs a whole file in one
    worker, and these small tensor ops would otherwise oversubscribe the
    cores the other workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_rmsnorm_rope_softcap_swiglu():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32) * 3
    scale = rng.normal(size=16).astype(np.float32)
    norm = layers.RMSNorm(16, torch.float32, "cpu")
    norm.scale.data.copy_(_t(scale))
    _close(layers.rmsnorm(norm, _t(x)),
           jlayers.rmsnorm({"scale": scale}, x))

    pos = np.arange(7) * 5
    for theta in (10_000.0, 1e6):
        _close(layers.rope(_t(x), _t(pos), theta),
               jlayers.rope(x, pos, theta))
    for cap in (None, 2.0, 30.0):
        _close(layers.softcap(_t(x), cap), jlayers.softcap(x, cap))

    d, f = 16, 24
    w = {n: rng.normal(size=s).astype(np.float32) * 0.3 for n, s in
         (("gate", (d, f)), ("up", (d, f)), ("down", (f, d)))}
    mlp = layers.SwiGLU(None, d, f, torch.float32, "cpu")
    for n, a in w.items():
        getattr(mlp, n).w.data.copy_(_t(a))
    h = x.reshape(-1, 16)
    _close(layers.swiglu(mlp, _t(h)),
           jlayers.swiglu({n: {"w": a} for n, a in w.items()}, h), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 32)).astype(np.float32) * 4
    x[0, 0, 0] = 0.0                       # an all-zero row: scale 1e-6/127
    x[1, 2, 1, :4] = 127.0 / 254 * 2       # halves: round to even
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(layers.dtype_of(dtype))
    q, s = attention.quantize_kv(tx)
    jq, js = jattn.quantize_kv(jx)
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    back = attention.dequantize_kv(q, s, torch.float32)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jattn.dequantize_kv(jq, js, jnp.float32)),
        rtol=1e-6, atol=0)


def _qkv(rng, b, lq, lk, h, hkv, hd):
    q = rng.normal(size=(b, lq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, lk, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, lk, hkv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal,window,cap,lk", [
    (True, None, None, 20),     # causal, q and kv padded to blocks of 8
    (True, 5, None, 20),        # sliding window
    (True, None, 50.0, 20),     # gemma2's score softcap
    (False, None, None, 13),    # cross attention: padded keys take part
    (False, None, None, 16),    # no padding
])
def test_attention_core_blockwise(causal, window, cap, lk):
    rng = np.random.default_rng(2)
    b, lq, h, hkv, hd = 2, 20 if causal else 11, 4, 2, 16
    q, k, v = _qkv(rng, b, lq, lk, h, hkv, hd)
    cfg = dataclasses.replace(ARCHS["gemma2-9b"].reduced(),
                              attn_softcap=cap)
    jcfg = dataclasses.replace(JAX_ARCHS["gemma2-9b"].reduced(),
                               attn_softcap=cap)
    qpos, kpos = np.arange(lq), np.arange(lk)
    kw = dict(causal=causal, window=window, q_block=8, kv_block=8)
    got = attention.attention_core(_t(q), _t(k), _t(v), cfg,
                                   q_positions=_t(qpos),
                                   k_positions=_t(kpos), **kw)
    want = jattn.attention_core(q, k, v, jcfg, q_positions=qpos,
                                k_positions=kpos, **kw)
    _close(got, want)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked(with_h0):
    rng = np.random.default_rng(3)
    b, l, h, p, n, chunk = 2, 32, 3, 8, 6, 8
    xh = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, l, h)))).astype(np.float32)
    a = -np.exp(np.log(np.linspace(1.0, 16.0, h))).astype(np.float32)
    bm = rng.normal(size=(b, l, n)).astype(np.float32)
    cm = rng.normal(size=(b, l, n)).astype(np.float32)
    h0 = (rng.normal(size=(b, h, p, n)).astype(np.float32)
          if with_h0 else None)
    y, hf = ssm._ssd_chunked(_t(xh), _t(dt), _t(a), _t(bm), _t(cm), chunk,
                             None if h0 is None else _t(h0))
    jy, jhf = jssm._ssd_chunked(xh, dt, a, bm, cm, chunk, h0)
    _close(y, jy, atol=1e-5)
    _close(hf, jhf, atol=1e-5)


def _moe_pair(rng, cfg):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    w = {"router": rng.normal(size=(d, e)).astype(np.float32)
         * d ** -0.5,
         "gate": rng.normal(size=(e, d, f)).astype(np.float32) * d ** -0.5,
         "up": rng.normal(size=(e, d, f)).astype(np.float32) * d ** -0.5,
         "down": rng.normal(size=(e, f, d)).astype(np.float32) * f ** -0.5}
    mod = moe.MoE(None, cfg, torch.float32, "cpu")
    mod.router.w.data.copy_(_t(w["router"]))
    for n in ("gate", "up", "down"):
        getattr(mod, n).data.copy_(_t(w[n]))
    return mod, {"router": {"w": w["router"]},
                 **{n: w[n] for n in ("gate", "up", "down")}}


def _jax_ranks(ids, e, cap):
    """moe.py's capacity lines, on the JAX side's ids."""
    flat = ids.reshape(-1)
    oh = jax.nn.one_hot(flat, e, dtype=jnp.int32)
    rank = jnp.sum((jnp.cumsum(oh, axis=0) - oh) * oh, axis=-1)
    return np.asarray(rank), np.asarray(rank < cap)


@pytest.mark.parametrize("case", ["random", "drops", "ties"])
def test_moe_tokens(case):
    rng = np.random.default_rng(4)
    base = ARCHS["moonshot-v1-16b-a3b"].reduced()
    cfg = dataclasses.replace(base, num_experts=8, num_experts_per_tok=3)
    jcfg = dataclasses.replace(JAX_ARCHS["moonshot-v1-16b-a3b"].reduced(),
                               num_experts=8, num_experts_per_tok=3)
    t, d = 96, cfg.d_model
    mod, jp = _moe_pair(rng, cfg)
    xt = rng.normal(size=(t, d)).astype(np.float32)
    if case == "drops":   # a third of the tokens share one row: overflow
        xt[::3] = xt[0]
    if case == "ties":    # a zero router: every probability 1/E
        jp["router"]["w"][:] = 0.0
        mod.router.w.data.zero_()
    y, aux, ids = moe._moe_tokens(mod, _t(xt), cfg)
    jy, jaux, jids = jmoe._moe_tokens(jp, xt, jcfg)
    assert ids.dtype == torch.int32
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    if case == "ties":
        assert np.array_equal(ids.numpy(), np.tile(np.arange(3), (t, 1)))
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = max(int(t // e * k * cfg.capacity_factor) + 1, k)
    rank, keep, _ = moe._capacity_slots(ids.long().reshape(-1), e, cap)
    jrank, jkeep = _jax_ranks(jids, e, cap)
    assert np.array_equal(rank.numpy(), jrank)
    assert np.array_equal(keep.numpy(), jkeep)
    if case == "random":
        assert keep.all()
    else:
        assert not keep.all()
    _close(y, jy)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)
