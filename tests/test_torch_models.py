"""The port's language models (``repro_torch.models``) against the JAX
package's on the CPU, for every architecture at ``reduced()`` in float32.

The weights are the JAX package's ``init_params(key(0))``, carried across
by ``models.convert.params_from_tree``; prompts, image prefixes (llava)
and encoder frames (whisper) are seeded numpy arrays. Held at rtol and
atol 1e-4 (measured: the largest difference is 1.9e-5, jamba's hidden
states of magnitude 12; logits differ by at most 9.1e-6):

* ``forward_hidden`` (hidden states and the MoE aux loss) and
  ``lm_logits`` of every position;
* ``prefill``: the last logits and every cache leaf (K/V, int8 values
  and scales, ring slots, Mamba conv and SSM states, whisper's cross
  K/V), then three ``decode_step``s from the port's own cache, logits and
  every cache leaf after each;
* the greedy steps (``make_prefill_step``/``make_decode_step``): equal
  tokens wherever the JAX logits' top-2 margin exceeds the tolerance;
* MoE expert ids (``moe_ffn`` on the first MoE layer, the telemetry
  path) equal exactly, and the forward-only loss (``make_loss_fn``).

Extra cases: qwen2-1.5b with an int8 cache and gemma2-9b with a float
ring cache whose prompt (24) is longer than its window (16); gemma2's
own config caches in int8 (``tests/test_kv_quant.py``'s two archs). An
int8 value sits on a rounding boundary now and then (one in ~16,000 at
these shapes): int8 leaves are held within one quantum, a thousandth of
them at most differing, and an int8 arch's decode steps start from the
JAX package's own cache each step, so that a boundary value flipped in
the prefill is not held against the decode.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import convert, moe, steps  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

TOL = 1e-4
B, L, DECODES = 2, 32, 3
#: case id -> (arch, config overrides, prompt length)
CASES = {name: (name, {}, L) for name in sorted(ARCHS)}
CASES["qwen2-1.5b-int8"] = ("qwen2-1.5b", {"kv_cache_dtype": "int8"}, L)
CASES["gemma2-9b-ring"] = ("gemma2-9b", {"kv_cache_dtype": "bfloat16"}, 24)
MOE_ARCHS = [n for n in sorted(ARCHS) if ARCHS[n].num_experts]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the parallel suite runs a whole file in one
    worker, and these small tensor ops would otherwise oversubscribe the
    cores the other workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(case):
    arch, over, _ = CASES[case]
    return (dataclasses.replace(ARCHS[arch].reduced(), **over),
            dataclasses.replace(JAX_ARCHS[arch].reduced(), **over))


def _inputs(cfg, prompt):
    """Seeded prompts (B, text length) and the modality embeddings."""
    rng = np.random.default_rng(1)
    text = prompt - (cfg.num_image_tokens if cfg.family == "vlm" else 0)
    toks = rng.integers(0, cfg.vocab_size, (B, text)).astype(np.int32)
    emb = None
    if cfg.family == "vlm":
        emb = rng.normal(size=(B, cfg.num_image_tokens, cfg.d_model))
    if cfg.is_enc_dec:
        emb = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
    return toks, None if emb is None else emb.astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """The JAX package's side of a case, each function compiled once: the
    forward, the prefill and three greedy decode steps (their logits and
    caches), and the weights as numpy arrays."""
    _, jcfg = _configs(case)
    prompt = CASES[case][2]
    params = jtfm.init_params(jax.random.key(0), jcfg)
    toks, emb = _inputs(jcfg, prompt)
    fwd = jax.jit(lambda p, t, e: jtfm.forward_hidden(p, jcfg, t, embeds=e))
    hidden, aux = fwd(params, toks, emb)
    logits_all = jax.jit(lambda p, h: jtfm.lm_logits(p, jcfg, h))(params,
                                                                  hidden)
    pre = jax.jit(lambda p, t, c, e: jtfm.prefill(p, jcfg, t, c, embeds=e))
    cache = jtfm.init_cache(jcfg, B, prompt + 8)
    logits, cache = pre(params, toks, cache, emb)
    run = {"params": _np_tree(params), "toks": toks, "emb": emb,
           "hidden": np.asarray(hidden), "aux": float(aux),
           "logits_all": np.asarray(logits_all),
           "prefill": np.asarray(logits), "cache": _np_tree(cache),
           "steps": []}
    dec = jax.jit(lambda p, t, c, pos: jtfm.decode_step(p, jcfg, t, c, pos))
    tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
    for i in range(DECODES):
        logits, new = dec(params, tok, cache, jnp.asarray(prompt + i))
        run["steps"].append({"tok": tok, "cache_in": _np_tree(cache),
                             "logits": np.asarray(logits),
                             "cache": _np_tree(new)})
        cache = new
        tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
    return run


@functools.lru_cache(maxsize=None)
def _model(case):
    cfg, _ = _configs(case)
    return convert.params_from_tree(cfg, _jax_run(case)["params"], "cpu")


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _same_cache(cfg, cache, want):
    """Every leaf of the port's cache against the reference's tree."""
    got = convert.cache_to_tree(cfg, cache)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        if w.dtype == np.int8:
            diff = np.abs(g.astype(np.int16) - w.astype(np.int16))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        else:
            _close(g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    cfg, _ = _configs(case)
    run = _jax_run(case)
    model = _model(case)
    hidden, aux = tfm.forward_hidden(model, cfg, _t(run["toks"]),
                                     embeds=_t(run["emb"]))
    _close(hidden, run["hidden"])
    np.testing.assert_allclose(float(aux), run["aux"], rtol=TOL, atol=TOL)
    _close(tfm.lm_logits(model, cfg, hidden), run["logits_all"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_match_jax(case):
    cfg, _ = _configs(case)
    run = _jax_run(case)
    model = _model(case)
    prompt = CASES[case][2]
    cache = tfm.init_cache(cfg, B, prompt + 8, "cpu")
    logits, cache = tfm.prefill(model, cfg, _t(run["toks"]), cache,
                                embeds=_t(run["emb"]))
    _close(logits, run["prefill"])
    _same_cache(cfg, cache, run["cache"])
    int8 = cfg.kv_cache_dtype == "int8" and cfg.has_attention
    for i, step in enumerate(run["steps"]):
        if int8:
            cache = convert.cache_from_tree(cfg, step["cache_in"], "cpu")
        logits, cache = tfm.decode_step(model, cfg, _t(step["tok"]), cache,
                                        prompt + i)
        _close(logits, step["logits"])
        _same_cache(cfg, cache, step["cache"])


def _confident(logits):
    """Rows whose top-2 margin exceeds the tolerance."""
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0] > 2 * TOL


@pytest.mark.parametrize("case", ["qwen2-1.5b", "mamba2-370m",
                                  "moonshot-v1-16b-a3b", "whisper-large-v3"])
def test_greedy_steps_match_jax(case):
    """make_prefill_step / make_decode_step against the JAX package's: the
    same next tokens wherever the JAX logits are not a near tie."""
    cfg, _ = _configs(case)
    run = _jax_run(case)
    model = _model(case)
    prompt = CASES[case][2]
    batch = {"tokens": _t(run["toks"])}
    if run["emb"] is not None:
        batch["embeds"] = _t(run["emb"])
    cache = tfm.init_cache(cfg, B, prompt + 8, "cpu")
    tok, cache = steps.make_prefill_step(cfg)(model, batch, cache)
    assert tok.dtype == torch.int32 and tok.shape == (B,)
    sure = _confident(run["prefill"])
    want = np.argmax(run["prefill"], -1)
    assert np.array_equal(tok.numpy()[sure], want[sure])
    step = steps.make_decode_step(cfg)
    for i, ref in enumerate(run["steps"]):
        tok, cache = step(model, _t(ref["tok"]), cache, prompt + i)
        assert tok.shape == (B, 1)
        sure = _confident(ref["logits"])
        want = np.argmax(ref["logits"], -1)
        assert np.array_equal(tok.numpy()[sure, 0], want[sure])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_expert_ids_match_jax(arch):
    """The routing telemetry path: ``embed_lookup`` then the first MoE
    layer's ``moe_ffn``; ids equal exactly, outputs at the tolerance."""
    cfg, jcfg = _configs(arch)
    run = _jax_run(arch)
    model = _model(arch)
    j = next(i for i, k in enumerate(cfg.layer_pattern) if k.endswith("_moe"))
    ffn = jax.tree.map(lambda a: a[0], run["params"]["blocks"][j])["ffn"]
    x = jtfm.embed_lookup(run["params"], jcfg, run["toks"])
    jy, jaux, jids = jmoe.moe_ffn(ffn, x, jcfg)
    y, aux, ids = moe.moe_ffn(model.blocks[j].ffn,
                              tfm.embed_lookup(model, cfg, _t(run["toks"])),
                              cfg)
    assert ids.shape == (B * run["toks"].shape[1],
                         cfg.num_experts_per_tok)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    _close(y, np.asarray(jy))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL)


@pytest.mark.parametrize("case", ["qwen2-1.5b", "llava-next-34b",
                                  "moonshot-v1-16b-a3b"])
def test_loss_matches_jax(case):
    """The forward-only loss (chunked CE over 64-position chunks, the
    vlm's text positions only, plus the MoE aux term)."""
    cfg, jcfg = _configs(case)
    run = _jax_run(case)
    toks = run["toks"]
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "loss_mask": (np.arange(toks.shape[1]) % 3 != 0)[None]
             .repeat(B, 0).astype(np.float32)}
    if run["emb"] is not None:
        batch["embeds"] = run["emb"]
    jloss, jm = jsteps.make_loss_fn(jcfg)(
        jax.tree.map(jnp.asarray, run["params"]), batch)
    loss, m = steps.make_loss_fn(cfg)(_model(case),
                                      {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), rtol=TOL)
