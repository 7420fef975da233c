"""The Whisper decoder step's kernels (turbo_whisper_workspace_tpu_torch/ops/
whisper_ops.py, and llama_ops.llama_attention at group 1) against the JAX
package.

The JAX package has no such module: XLA fuses this work inside its
jitted decode loop (turbo_whisper_workspace_tpu/models/whisper.py:
432-681, decode/greedy.py, decode/beam.py). Each plain version is held
here against the JAX code it replaces, on the same numpy inputs from a
seed, in f32 at tiny widths (2 heads of 32 dims, or 4 of 16):

* the residual add and `layer_norm` (models/whisper.py:182-189), and the
  decoder's entry (the embeddings' gather and add, :465-467) with its
  first norm: relative L2 within 1e-6 (the frameworks' sums part in the
  last bits);
* `_quantize_kv_rows` with the dynamic_update_slice writes into the bf16,
  the int8 and the beam-lane cache (:420-430, :518-580, :604-605), at a
  host pos and at a 0-dim tensor pos (jitted, traced): bit-equal;
* `DecodeRules.apply` followed by greedy's argmax (and Gumbel-max on the
  same noise), log_softmax and the token's log-probability, and by
  beam's alive_scores + log_softmax: the tokens equal, the
  log-probabilities within 1e-5 absolute (1e-6 relative);
* `llama_attention_reference` at group 1 and head dim 16 against JAX
  `mha` under the position mask (:602-613), rows past pos random: 1e-6.

A torch mirror of csrc/whisper_logit_rules.cu's passes (the side
maxima, the timestamps' sum with the filled entries counted, the final
row's maximum taken from the sides) is held to the plain version,
including rows whose timestamps are all masked. The norms' autograd
route (the kernel's forward, the plain version's backward) is held to
the plain version's gradients with the launch patched to the plain
version: 1e-6. `cuda`-marked cases, skipped here, hold each kernel to
its plain version on the card.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbo_whisper_workspace_tpu.decode import rules as jrules
from turbo_whisper_workspace_tpu.decode import tokenizer as jtok
from turbo_whisper_workspace_tpu.models import whisper as jwm
from turbo_whisper_workspace_tpu_torch.decode import rules as trules
from turbo_whisper_workspace_tpu_torch.decode import tokenizer as ttok
from turbo_whisper_workspace_tpu_torch.models import whisper as twm
from turbo_whisper_workspace_tpu_torch.ops import build
from turbo_whisper_workspace_tpu_torch.ops import llama_ops as lo
from turbo_whisper_workspace_tpu_torch.ops import whisper_ops as wo

from test_torch_quant import rel_l2

B, H, DH, S, L = 3, 2, 32, 12, 2
D = H * DH
TOL = 1e-6
VOCAB = 51865
SP_J = jtok.special_tokens_for_vocab(VOCAB)
SP_T = ttok.special_tokens_for_vocab(VOCAB)


def _rand(rng, *shape, scale=1.0) -> np.ndarray:
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# whisper_norm


def test_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, delta = _rand(rng, B, 4, D, scale=2.0), _rand(rng, B, 4, D)
    w, b = 1 + _rand(rng, D, scale=0.1), _rand(rng, D, scale=0.1)
    xo, h = wo.whisper_norm(*(torch.from_numpy(a) for a in (x, w, b)), 1e-5,
                            torch.from_numpy(delta))
    ln = {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}
    jx = jnp.asarray(x) + jnp.asarray(delta)
    assert rel_l2(xo.numpy(), np.asarray(jx)) <= TOL
    assert rel_l2(h.numpy(), np.asarray(jax.jit(jwm.layer_norm)(jx, ln))) <= TOL
    same, h0 = wo.whisper_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                               1e-5)
    assert torch.equal(same, torch.from_numpy(x))
    assert rel_l2(h0.numpy(), np.asarray(jwm.layer_norm(jnp.asarray(x), ln))) <= TOL
    # the module's forward is the plain version's norm
    mod = twm.LayerNorm(D)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w))
        mod.bias.copy_(torch.from_numpy(b))
    assert torch.equal(mod(torch.from_numpy(x)), h0)


@pytest.mark.parametrize("t,pos", [(3, 0), (1, 7), (1, "tensor")])
def test_embed_norm_matches_jax(t, pos):
    rng = np.random.default_rng(1)
    n_ctx, vocab = 16, 50
    temb, pemb = _rand(rng, vocab, D, scale=0.5), _rand(rng, n_ctx, D, scale=0.5)
    w, b = 1 + _rand(rng, D, scale=0.1), _rand(rng, D, scale=0.1)
    tokens = rng.integers(0, vocab, (B, t))
    p = 9 if pos == "tensor" else pos
    at = torch.tensor(p) if pos == "tensor" else p
    x, h = wo.whisper_embed_norm(torch.from_numpy(tokens), torch.from_numpy(temb),
                                 torch.from_numpy(pemb), at, torch.from_numpy(w),
                                 torch.from_numpy(b), 1e-5)

    @jax.jit
    def ref(tokens, temb, pemb, p):
        jx = temb[tokens] + pemb[p + jnp.arange(t)]
        return jx, jwm.layer_norm(jx, {"scale": jnp.asarray(w), "bias": jnp.asarray(b)})

    jx, jh = ref(tokens, temb, pemb, p)
    assert x.shape == (B, t, D)
    assert rel_l2(x.numpy(), np.asarray(jx)) <= TOL
    assert rel_l2(h.numpy(), np.asarray(jh)) <= TOL


# ---------------------------------------------------------------------------
# whisper_kv_rows


def _jax_write(mode: str, cache: dict, k, v, li: int, pos, beam: int) -> dict:
    """models/whisper.py:decoder_forward's cache update of layer li."""
    if mode == "bf16":
        return {name: jax.lax.dynamic_update_slice(cache[name], x[None].astype(
            cache[name].dtype), (li, 0, pos, 0)) for name, x in (("k", k), ("v", v))}
    kq, ks = jwm._quantize_kv_rows(k, H)
    vq, vs = jwm._quantize_kv_rows(v, H)
    if mode == "int8":
        return {name: jax.lax.dynamic_update_slice(cache[name], x[None], (li, 0, 0, pos) + (
            (0,) if x.ndim == 4 else ())) for name, x in (("k_q", kq), ("k_s", ks),
                                                         ("v_q", vq), ("v_s", vs))}
    br = k.shape[0] // beam
    knew = kq[:, :, 0].reshape(br, beam, D)
    vnew = vq[:, :, 0].reshape(br, beam, D)
    ksnew = ks[:, :, 0].reshape(br, beam, H)
    vsnew = vs[:, :, 0].reshape(br, beam, H)
    return {
        "k_p": jax.lax.dynamic_update_slice(
            cache["k_p"], knew.transpose(0, 2, 1)[None, :, :, :, None], (li, 0, 0, 0, pos)),
        "v_p": jax.lax.dynamic_update_slice(cache["v_p"], vnew[None, :, :, None, :],
                                            (li, 0, 0, pos, 0)),
        "k_ps": jax.lax.dynamic_update_slice(
            cache["k_ps"], ksnew.transpose(0, 2, 1)[None, :, :, :, None], (li, 0, 0, 0, pos)),
        "v_ps": jax.lax.dynamic_update_slice(
            cache["v_ps"], vsnew.transpose(0, 2, 1)[None, :, :, :, None], (li, 0, 0, 0, pos)),
    }


def _caches(mode: str, rows: int, beam: int, rng) -> dict:
    """A cache of `mode` with random contents, as numpy arrays."""
    if mode == "bf16":
        return {n: _rand(rng, L, rows, S, D) for n in ("k", "v")}
    if mode == "int8":
        return {"k_q": rng.integers(-127, 128, (L, rows, H, S, DH)).astype(np.int8),
                "v_q": rng.integers(-127, 128, (L, rows, H, S, DH)).astype(np.int8),
                "k_s": np.abs(_rand(rng, L, rows, H, S)), "v_s": np.abs(_rand(rng, L, rows, H, S))}
    br = rows // beam
    return {"k_p": rng.integers(-127, 128, (L, br, D, beam, S)).astype(np.int8),
            "v_p": rng.integers(-127, 128, (L, br, beam, S, D)).astype(np.int8),
            "k_ps": np.abs(_rand(rng, L, br, H, beam, S)),
            "v_ps": np.abs(_rand(rng, L, br, H, beam, S))}


@pytest.mark.parametrize("mode,t,beam,pos_kind", [
    ("bf16", 1, 1, "host"), ("bf16", 4, 1, "host"), ("bf16", 1, 1, "tensor"),
    ("int8", 1, 1, "host"), ("int8", 3, 1, "host"), ("int8", 1, 1, "tensor"),
    ("lanes", 1, 3, "host"), ("lanes", 1, 3, "tensor")])
def test_kv_rows_match_jax(mode, t, beam, pos_kind):
    """A tensor pos writes one row (the decode step); a host pos the
    prompt's t rows too. The scales compare as f32 values of bf16."""
    rng = np.random.default_rng(2)
    rows = B * beam
    k, v = _rand(rng, rows, t, D, scale=2.0), _rand(rng, rows, t, D)
    k[0, 0, :DH] = 0.0                        # a zero head: the 1e-8 scale floor
    cache = _caches(mode, rows, beam, rng)
    pos = 5
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    for n in tcache:
        if n in ("k_s", "v_s", "k_ps", "v_ps"):
            tcache[n] = tcache[n].to(torch.bfloat16)
    jcache = {n: jnp.asarray(tcache[n].float().numpy() if tcache[n].is_floating_point()
                             else tcache[n].numpy()) for n in tcache}
    if mode != "bf16":
        jcache = {n: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x
                  for n, x in jcache.items()}
    at = torch.tensor(pos) if pos_kind == "tensor" else pos
    wo.whisper_kv_rows(torch.from_numpy(k), torch.from_numpy(v), tcache, 1, at, H, beam)
    write = jax.jit(lambda c, k, v, p: _jax_write(mode, c, k, v, 1, p, beam))
    ref = write(jcache, jnp.asarray(k), jnp.asarray(v), pos)
    for n, x in tcache.items():
        np.testing.assert_array_equal(x.float().numpy(), np.asarray(ref[n].astype(jnp.float32)),
                                      err_msg=n)


# ---------------------------------------------------------------------------
# whisper_logit_rules


def _rules_inputs(rng, rows: int = 6):
    tsb = SP_J.timestamp_begin
    # rows: text/text, ts/text, ts/ts (no timestamp may follow), text/ts,
    # a raised floor, a floor past the vocabulary (every timestamp banned)
    last = np.array([100, tsb + 5, tsb + 7, 300, tsb + 9, tsb + 2], np.int64)[:rows]
    penult = np.array([200, 150, tsb + 3, tsb + 2, 17, 40], np.int64)[:rows]
    floor = np.array([tsb, tsb + 5, tsb + 8, tsb + 3, tsb + 40, VOCAB + 1], np.int64)[:rows]
    logits = _rand(rng, rows, VOCAB, scale=3.0)
    logits[1, tsb:] += 4.0                        # timestamp mass wins on row 1
    logits[3, tsb + 10] = 40.0                    # one timestamp wins on row 3
    return logits, last, penult, floor


def _jax_decode_body(jr, logits, is_begin, last, penult, floor, noise, temperature, alive):
    masked = jr.apply(logits, jnp.asarray(is_begin), last, penult, floor, jr.static_mask(),
                      jr.begin_mask())
    nxt = jnp.argmax(masked if noise is None else masked + temperature * noise, axis=-1)
    logp = jax.nn.log_softmax(masked, axis=-1)
    return nxt, jnp.take_along_axis(logp, nxt[:, None], axis=-1)[:, 0], alive[:, None] + logp


@pytest.mark.parametrize("timestamps", [True, False])
@pytest.mark.parametrize("is_begin", [True, False])
@pytest.mark.parametrize("sampled", [False, True])
def test_logit_rules_match_jax(timestamps, is_begin, sampled):
    rng = np.random.default_rng(3)
    logits, last, penult, floor = _rules_inputs(rng)
    noise = -np.log(rng.exponential(size=logits.shape)).astype(np.float32) if sampled else None
    alive = _rand(rng, len(last), scale=5.0)
    jr = jrules.DecodeRules(specials=SP_J, timestamps=timestamps)
    tr = trules.DecodeRules(specials=SP_T, timestamps=timestamps)
    ref = jax.jit(lambda *a: _jax_decode_body(jr, *a), static_argnums=(1,))(
        logits, is_begin, last, penult, floor, noise, 0.6, alive)
    got = wo.whisper_logit_rules(
        torch.from_numpy(logits), tr, is_begin, *(torch.from_numpy(a) for a in
                                                  (last, penult, floor)),
        tr.static_mask(), tr.begin_mask(), None if noise is None else torch.from_numpy(noise),
        0.6, torch.from_numpy(alive))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-5, rtol=1e-6)
    assert wo.whisper_logit_rules(torch.from_numpy(logits), tr, is_begin,
                                  *(torch.from_numpy(a) for a in (last, penult, floor)),
                                  tr.static_mask(), tr.begin_mask())[2] is None


def rules_mirror(logits, rules, is_begin, last, penult, floor, static_mask, begin_mask):
    """csrc/whisper_logit_rules.cu's passes in torch: the masked row
    before the forcing, its two sides' maxima, the timestamps' sum with
    the tsb filled entries counted when the timestamps' maximum is −1e30,
    the forcing test, the final row's maximum from the sides, then the
    argmax and log-probabilities."""
    sp = rules.specials
    tsb, neg, zero = sp.timestamp_begin, torch.tensor(trules.NEG_INF), torch.tensor(0.0)
    v = torch.arange(logits.shape[1])
    m = logits + static_mask
    if is_begin:
        m = m + begin_mask
    is_ts = v >= tsb
    if not rules.timestamps:
        m = m + torch.where(is_ts, neg, zero)
    elif not is_begin:
        lt, pt = (last >= tsb)[:, None], (penult >= tsb)[:, None]
        ban = (lt & pt & is_ts) | (lt & ~pt & (v < sp.eot)) | (is_ts & (v < floor[:, None]))
        m = torch.where(ban, neg, m)
    text_max, ts_max = m[:, :tsb].amax(-1), m[:, tsb:].amax(-1)
    force = torch.zeros(len(m), dtype=torch.bool)
    if rules.timestamps:
        m_ts = torch.clamp(ts_max, min=neg)
        total = torch.exp(m[:, tsb:] - m_ts[:, None]).sum(-1) + torch.where(
            m_ts == neg, float(tsb), 0.0)
        force = torch.log(total) + m_ts > torch.clamp(text_max, min=neg)
    f = torch.where(force[:, None] & ~is_ts, neg, m)
    big = torch.where(force, torch.clamp(ts_max, min=neg), torch.maximum(text_max, ts_max))
    log_sum = torch.log(torch.exp(f - big[:, None]).sum(-1))
    nxt = f.argmax(-1)
    return nxt, (f.gather(-1, nxt[:, None])[:, 0] - big) - log_sum, (f - big[:, None]) - log_sum[
        :, None]


@pytest.mark.parametrize("timestamps", [True, False])
@pytest.mark.parametrize("is_begin", [True, False])
def test_logit_rules_mirror_matches_plain_version(timestamps, is_begin):
    rng = np.random.default_rng(4)
    logits, last, penult, floor = (torch.from_numpy(a) for a in _rules_inputs(rng))
    tr = trules.DecodeRules(specials=SP_T, timestamps=timestamps)
    args = (tr, is_begin, last, penult, floor, tr.static_mask(), tr.begin_mask())
    nxt, logp, cand = wo.whisper_logit_rules_reference(logits, *args,
                                                       add=torch.zeros(len(last)))
    mnxt, mlogp, mcand = rules_mirror(logits, *args)
    assert torch.equal(nxt, mnxt)
    torch.testing.assert_close(mlogp, logp, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(mcand, cand, rtol=1e-6, atol=1e-5)
    if timestamps and not is_begin:
        # the last row's timestamps are all masked: its forcing test
        # compares log(tsb) − 1e30 = −1e30 with the text maximum
        assert (cand[5, SP_T.timestamp_begin:] < -1e29).all() and nxt[5] < SP_T.timestamp_begin


# ---------------------------------------------------------------------------
# llama_attention at group 1: the decoder's self-attention over the bf16 cache


@pytest.mark.parametrize("t,pos", [(1, 0), (1, 9), (3, 0), (4, 6)])
def test_attention_at_group_one_matches_jax_mha(t, pos):
    """Rows past pos + t hold random values. The port's plain Whisper
    attention fills masked keys with −inf, llama_attention_reference
    with −1e30: key 0 is always visible, so both give exact zeros."""
    rng = np.random.default_rng(5)
    h, dh = 4, 16
    q, ck, cv = _rand(rng, B, t, h * dh), _rand(rng, B, S, h * dh), _rand(rng, B, S, h * dh)
    got = lo.llama_attention(torch.from_numpy(q).reshape(B, t, h, dh), torch.from_numpy(ck),
                             torch.from_numpy(cv), pos)
    mask = np.arange(S)[None, :] <= pos + np.arange(t)[:, None]

    @jax.jit
    def ref(q, ck, cv):
        return jwm.mha(q, ck, cv, h, mask=jnp.asarray(mask)[None, None])

    assert got.shape == (B, t, h * dh)
    assert rel_l2(got.numpy(), np.asarray(ref(q, ck, cv))) <= TOL
    inf_mask = torch.from_numpy(mask)[None, None]
    plain = twm._plain_attention(torch.from_numpy(q), torch.from_numpy(ck),
                                 torch.from_numpy(cv), h, inf_mask)
    assert rel_l2(got.numpy(), plain.numpy()) <= TOL
    assert torch.equal(got, lo.llama_attention(torch.from_numpy(q).reshape(B, t, h, dh),
                                               torch.from_numpy(ck), torch.from_numpy(cv),
                                               torch.tensor(pos)))


# ---------------------------------------------------------------------------
# the wrappers and the decoder's calls


def test_wrappers_run_plain_versions_on_cpu_and_name_their_launches():
    """CPU tensors never launch; each wrapper passes as many arguments as
    its C signature declares."""
    wo.reset_launch_counts()
    rng = np.random.default_rng(6)
    x = torch.from_numpy(_rand(rng, 2, D))
    w, b = torch.ones(D), torch.zeros(D)
    assert all(torch.equal(a, r) for a, r in zip(wo.whisper_norm(x, w, b, 1e-5, x),
                                                   wo.whisper_norm_reference(x, w, b, 1e-5, x)))
    assert wo.launch_counts == dict.fromkeys(wo.launch_counts, 0)
    tree = ast.parse(pathlib.Path(wo.__file__).read_text())
    calls = [(c.args[0].value, len(c.args) - 1) for c in ast.walk(tree)
             if isinstance(c, ast.Call) and getattr(c.func, "attr", "") == "launch"]
    assert {n for n, _ in calls} == set(wo.launch_counts)
    assert all(n_args == len(build.SIGNATURES[n]) for n, n_args in calls)


@pytest.mark.parametrize("cache_mode", ["bf16", "int8", "lanes"])
def test_decoder_step_calls_each_kernel_a_layer(cache_mode, monkeypatch):
    """One decode step at a tensor pos: the entry and three norms a layer
    plus `ln` (whisper_norm), one cache write a layer (whisper_kv_rows),
    llama_attention a layer on the bf16 cache; the encoder two norms a
    block plus ln_post."""
    dims = twm.WhisperDims(80, 1500, 64, 2, 2, 51865, 448, 64, 2, 2)
    model = twm.init_params(dims, torch.Generator().manual_seed(0))
    calls = []
    for mod, names in ((wo, ("whisper_norm", "whisper_embed_norm", "whisper_kv_rows")),
                       (lo, ("llama_attention",))):
        for name in names:
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k:
                                calls.append(_n) or _f(*a, **k))
    rng = np.random.default_rng(7)
    with torch.no_grad():
        feats = model.encoder(torch.from_numpy(_rand(rng, 1, 80, 3000)))
        assert calls == ["whisper_norm"] * (2 * dims.n_audio_layer + 1)
        ckv = model.decoder.precompute_cross_kv(feats.expand(2, -1, -1).contiguous(),
                                                quantize=True)
        beam = 2 if cache_mode == "lanes" else 1
        cache = twm.init_kv_cache(dims, 2, 8, dtype=torch.float32,
                                  quantize=cache_mode != "bf16")
        model.decoder(torch.tensor([[1, 2, 3], [4, 5, 6]]), ckv, cache, pos=0)
        lane_map = None
        if cache_mode == "lanes":
            cache = twm.beam_lane_cache(cache, beam)
            lane_map = torch.zeros((2, beam, 8), dtype=torch.int32)
        calls.clear()
        model.decoder(torch.arange(2 * beam)[:, None] + 7, ckv, cache, pos=torch.tensor(3),
                      beam=beam, lane_map=lane_map)
    n = dims.n_text_layer
    assert calls.count("whisper_embed_norm") == 1
    assert calls.count("whisper_norm") == 3 * n
    assert calls.count("whisper_kv_rows") == n
    assert calls.count("llama_attention") == (n if cache_mode == "bf16" else 0)


@pytest.mark.parametrize("route", ["norm", "norm_delta", "embed"])
def test_norm_autograd_route_matches_plain_gradients(route, monkeypatch):
    """WhisperNorm's and WhisperEmbedNorm's wiring on the CPU: the
    forward's launch patched to the plain version, the outputs and the
    gradients those of the plain version's autograd (relative L2 1e-6),
    the launch made once, without autograd."""
    calls = []

    def launch(plain):
        def run(*args):
            calls.append(torch.is_grad_enabled())
            return plain(*args)
        return run

    monkeypatch.setattr(wo, "_whisper_norm_launch", launch(wo.whisper_norm_reference))
    monkeypatch.setattr(wo, "_whisper_embed_norm_launch",
                        launch(wo.whisper_embed_norm_reference))
    rng = np.random.default_rng(9)
    w, b = 1 + _rand(rng, D, scale=0.1), _rand(rng, D, scale=0.1)
    tokens = torch.from_numpy(rng.integers(0, 50, (B, 3)))
    if route == "embed":
        arrays = [_rand(rng, 50, D), _rand(rng, 16, D), w, b]

        def run(fn, temb, pemb, w, b):
            return fn(tokens, temb, pemb, 2, w, b, 1e-5)

        ours_fn, plain_fn = wo.WhisperEmbedNorm.apply, wo.whisper_embed_norm_reference
    else:
        arrays = [_rand(rng, B, 4, D, scale=2.0), w, b]
        if route == "norm_delta":
            arrays.append(_rand(rng, B, 4, D))

        def run(fn, x, w, b, delta=None):
            return fn(x, w, b, 1e-5, delta)

        def ours_fn(x, w, b, eps, delta):
            h = wo.WhisperNorm.apply(x, w, b, eps, delta)
            return h if delta is not None else (x, h)

        plain_fn = wo.whisper_norm_reference
    ours_leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    plain_leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    ours, plain = run(ours_fn, *ours_leaves), run(plain_fn, *plain_leaves)
    for a, r in zip(ours, plain):
        assert rel_l2(a.detach().numpy(), r.detach().numpy()) <= TOL
    grads = [torch.from_numpy(_rand(rng, *t.shape)) for t in plain]
    torch.autograd.backward(ours, grads)
    torch.autograd.backward(plain, grads)
    for a, r in zip(ours_leaves, plain_leaves):
        assert rel_l2(a.grad.numpy(), r.grad.numpy()) <= TOL
    assert calls == [False]


def test_training_forward_calls_the_norm_wrappers(monkeypatch):
    """A teacher-forced forward that autograd records (a training step)
    calls whisper_norm and whisper_embed_norm as a decode step does: the
    wrappers decide the route, the model takes no plain version itself."""
    dims = twm.WhisperDims(80, 1500, 64, 2, 2, 51865, 448, 64, 2, 2)
    model = twm.init_params(dims, torch.Generator().manual_seed(0)).requires_grad_(True)
    calls = []
    for name in ("whisper_norm", "whisper_embed_norm", "whisper_norm_reference",
                 "whisper_embed_norm_reference"):
        fn = getattr(wo, name)
        monkeypatch.setattr(wo, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    rng = np.random.default_rng(8)
    logits = model(torch.from_numpy(_rand(rng, 1, 80, 3000)), torch.tensor([[1, 2, 3]]))
    logits.sum().backward()
    n_enc, n_dec = dims.n_audio_layer, dims.n_text_layer
    assert calls.count("whisper_norm") == 2 * n_enc + 1 + 3 * n_dec
    assert calls.count("whisper_embed_norm") == 1
    # each plain version run came through its wrapper (the CPU's route)
    assert calls.count("whisper_norm_reference") == calls.count("whisper_norm")
    assert calls.count("whisper_embed_norm_reference") == 1
    assert model.decoder.token_emb.grad is not None
    assert model.encoder.blocks[0].attn_ln.weight.grad is not None


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(8, 1280), (40, 1280), (3000, 1280), (5, 384)])
def test_cuda_norm_matches_plain_version(cuda_device, m, d):
    """x' bit-equal; h within one bf16 ulp of F.layer_norm's (Welford's
    statistics on the card)."""
    gen = torch.Generator(cuda_device).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(torch.bfloat16)

    def within_one_ulp(got, ref):
        """one bf16 ulp at the larger magnitude, or 2^-20 absolute (near 0
        an O(1) term's f32 rounding is many ulps of the value)"""
        g, r = got.float(), ref.float()
        big = torch.maximum(g.abs(), r.abs())
        _, exp = torch.frexp(big)
        diff = (g - r).abs()
        return bool(((diff <= torch.ldexp(torch.ones_like(big), exp - 8))
                     | (diff <= 2.0 ** -20)).all())

    x, delta, w, b = randn(m, d), randn(m, d), randn(d), randn(d)
    for dl in (delta, None):
        xo, h = wo.whisper_norm(x, w, b, 1e-5, dl)
        rx, rh = wo.whisper_norm_reference(x, w, b, 1e-5, dl)
        assert torch.equal(xo, rx) and within_one_ulp(h, rh)
    tokens = torch.randint(0, 500, (m, 1), generator=gen, device=cuda_device)
    temb, pemb = randn(500, d), randn(448, d)
    for pos in (7, torch.tensor(446, device=cuda_device)):
        x, h = wo.whisper_embed_norm(tokens, temb, pemb, pos, w, b, 1e-5)
        rx, rh = wo.whisper_embed_norm_reference(tokens, temb, pemb, pos, w, b, 1e-5)
        assert torch.equal(x, rx) and within_one_ulp(h, rh)


@pytest.mark.cuda
def test_cuda_norm_autograd_matches_plain_gradients(cuda_device):
    """The training route on the card: the kernel's forward behind
    WhisperNorm / WhisperEmbedNorm, one launch each, gradients within
    relative L2 1e-2 of the plain version's autograd (bf16)."""
    gen = torch.Generator(cuda_device).manual_seed(4)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(torch.bfloat16)

    def leaves(*tensors):
        return [t.clone().requires_grad_() for t in tensors]

    x, delta, w, b, g = randn(3000, 1280), randn(3000, 1280), randn(1280), randn(1280), \
        randn(2, 3000, 1280)
    wo.reset_launch_counts()
    ours, plain = leaves(x, w, b, delta), leaves(x, w, b, delta)
    torch.autograd.backward(wo.whisper_norm(*ours[:3], 1e-5, ours[3]), list(g))
    torch.autograd.backward(wo.whisper_norm_reference(*plain[:3], 1e-5, plain[3]), list(g))
    assert all(rel_l2(a.grad.float().cpu().numpy(), r.grad.float().cpu().numpy()) <= 1e-2
               for a, r in zip(ours, plain))
    tokens = torch.randint(0, 500, (4, 3), generator=gen, device=cuda_device)
    tables = (randn(500, 1280), randn(448, 1280), w, b)
    ours, plain = leaves(*tables), leaves(*tables)
    g = randn(2, 4, 3, 1280)
    torch.autograd.backward(wo.whisper_embed_norm(tokens, *ours[:2], 5, *ours[2:], 1e-5),
                            list(g))
    torch.autograd.backward(
        wo.whisper_embed_norm_reference(tokens, *plain[:2], 5, *plain[2:], 1e-5), list(g))
    assert all(rel_l2(a.grad.float().cpu().numpy(), r.grad.float().cpu().numpy()) <= 1e-2
               for a, r in zip(ours, plain))
    assert wo.launch_counts["whisper_norm"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("mode,rows,t,beam", [("bf16", 8, 1, 1), ("bf16", 8, 3, 1),
                                              ("int8", 40, 1, 1), ("int8", 8, 3, 1),
                                              ("lanes", 40, 1, 5)])
def test_cuda_kv_rows_match_plain_version(cuda_device, mode, rows, t, beam):
    """Bit-equal in every cache, at a host and at a device pos."""
    gen = torch.Generator(cuda_device).manual_seed(1)
    h, dh, s_len = 20, 64, 227
    dims = twm.WhisperDims(128, 1500, h * dh, h, 1, 51866, 448, h * dh, h, 2)
    quantize = mode != "bf16"
    cache = twm.init_kv_cache(dims, rows // beam if mode == "lanes" else rows, s_len,
                              device=cuda_device, quantize=quantize)
    if mode == "lanes":
        cache = twm.beam_lane_cache(cache, beam)
    for pos in (5, torch.tensor(200, device=cuda_device)):
        k, v = (torch.randn(rows, t, h * dh, generator=gen, device=cuda_device).to(
            torch.bfloat16) for _ in range(2))
        ref = {n: x.clone() for n, x in cache.items()}
        wo.whisper_kv_rows(k, v, cache, 1, pos, h, beam)
        wo.whisper_kv_rows_reference(k, v, ref, 1, pos, h, beam)
        torch.cuda.synchronize()
        for n in cache:
            assert torch.equal(cache[n], ref[n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("rows,timestamps,is_begin,sampled", [
    (8, True, False, False), (8, True, True, False), (8, True, False, True),
    (40, True, False, False), (8, False, False, False)])
def test_cuda_logit_rules_match_plain_version(cuda_device, rows, timestamps, is_begin, sampled):
    gen = torch.Generator(cuda_device).manual_seed(2)
    sp = ttok.special_tokens_for_vocab(51866)
    tr = trules.DecodeRules(specials=sp, timestamps=timestamps)
    logits = torch.randn(rows, 51866, generator=gen, device=cuda_device) * 3
    logits[::3, sp.timestamp_begin:] += 4.0
    tsb = sp.timestamp_begin
    last = torch.randint(tsb - 200, tsb + 200, (rows,), generator=gen, device=cuda_device)
    penult = torch.randint(tsb - 200, tsb + 200, (rows,), generator=gen, device=cuda_device)
    floor = torch.randint(tsb, tsb + 100, (rows,), generator=gen, device=cuda_device)
    noise = (-torch.log(torch.empty_like(logits).exponential_(generator=gen))
             if sampled else None)
    add = torch.randn(rows, generator=gen, device=cuda_device)
    args = (logits, tr, is_begin, last, penult, floor, tr.static_mask(cuda_device),
            tr.begin_mask(cuda_device), noise, 0.6, add)
    got, ref = wo.whisper_logit_rules(*args), wo.whisper_logit_rules_reference(*args)
    assert torch.equal(got[0], ref[0])
    torch.testing.assert_close(got[1], ref[1], rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-6, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,pos", [(8, 1, 0), (8, 1, 200), (40, 1, 120), (8, 3, 0),
                                     (2, 40, 0)])
def test_cuda_attention_at_whisper_shapes(cuda_device, b, t, pos):
    gen = torch.Generator(cuda_device).manual_seed(3)
    q = torch.randn(b, t, 20, 64, generator=gen, device=cuda_device).to(torch.bfloat16)
    ck, cv = (torch.randn(b, 227, 1280, generator=gen, device=cuda_device).to(torch.bfloat16)
              for _ in range(2))
    ref = lo.llama_attention_reference(q, ck, cv, pos)
    got = lo.llama_attention(q, ck, cv, torch.tensor(pos, device=cuda_device))
    assert rel_l2(got.float().cpu().numpy(), ref.float().cpu().numpy()) <= 5e-3
