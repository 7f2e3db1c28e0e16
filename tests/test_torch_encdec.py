"""whisper-small's encoder and cross-attention: the port against the JAX
package on the same weights, in float32 on the CPU at ``.smoke()`` (2
encoder and 2 decoder layers, 32 encoder positions).

  * The config copy equals the reference's field for field, and
    ``count_params`` (total and active) agrees on the full config
    (arithmetic on the parameter definitions; nothing is allocated).
  * ``encoder_forward`` within 1e-5 of the JAX function.
  * Logits of a train forward, a prefill and 4 decode steps within 1e-4
    of the JAX ``forward`` plus ``unembed``; the cross-attention K and V
    that prefill persists in ``cache["xattn"]`` within 1e-5.
  * An 8-token greedy transcript (prefill, then cached decode steps)
    equal to the JAX package's (the decode steps above are its first 4,
    fed the JAX transcript's tokens).
  * Decode reads the persisted K and V: with the cross-attention's K and
    V projections poisoned after prefill, decode gives the same logits;
    decode against teacher forcing, as ``test_serve_consistency.py``
    holds the reference; a train or prefill forward without frames
    raises, naming them.
  * The plain ``flash_prefill_ref`` in its non-causal form (queries not
    aligned with keys: the cross shape, and one decode query) against the
    Pallas kernel in interpret mode.

The layer norms' weights and biases and the MLP's biases (ones and zeros
at init) are drawn at random on both sides, so that their branches count.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.kernels import flash_prefill as jax_flash  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "whisper-small"
TOL = 1e-4         # f32 logits end to end
ENC_TOL = 1e-5     # the encoder's output and the persisted cross K, V
B, PROMPT, DECODE_STEPS, GREEDY, MAX_SEQ = 2, 12, 4, 8, 32


def _cfgs():
    return tuple(dataclasses.replace(get(ARCH).smoke(), dtype="float32")
                 for get in (get_config, t_get_config))


def _drawn_params(jc, seed):
    """The JAX package's init as numpy, with every norm weight and bias
    and the MLP's biases drawn from N(init, 0.1)."""
    params = jax.tree.map(np.asarray,
                          jparams.init_params(jc, jax.random.key(seed)))
    rng = np.random.default_rng(100 + seed)

    def draw(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                draw(v, path + (k,))
            elif k in ("bi", "bo") or path[-1].endswith("norm"):
                tree[k] = (v + rng.normal(0, 0.1, v.shape)).astype(v.dtype)
    draw(params, ())
    return params


@pytest.fixture(scope="module")
def reference():
    """Both configs, the drawn weights, the seeded tokens and frames, and
    the JAX package's encoder output, logits (a train forward, a prefill,
    and GREEDY decode steps, each fed the argmax of the step before: the
    greedy transcript) and the cross K / V that prefill persists."""
    jc, tc = _cfgs()
    params = _drawn_params(jc, 0)
    jp = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(10)
    prompt = rng.integers(2, jc.vocab_size, (B, PROMPT)).astype(np.int32)
    frames = rng.normal(0, 1, (B, jc.encoder_seq, jc.d_model)
                        ).astype(np.float32)
    jf = jnp.asarray(frames)
    enc = jmodel.encoder_forward(jc, jp, jf)
    fwd = jmodel.forward(jc, jp, jnp.asarray(prompt), frames=jf)
    logits = {"train": jmodel.unembed(jc, jp, fwd["hidden"])}
    fwd = jmodel.forward(jc, jp, jnp.asarray(prompt),
                         cache=jkv.init_cache(jc, B, MAX_SEQ),
                         mode="prefill", frames=jf)
    logits["prefill"] = jmodel.unembed(jc, jp, fwd["hidden"])
    xattn = {k: np.asarray(v) for k, v in fwd["cache"]["xattn"].items()}
    last, greedy = logits["prefill"][:, -1], []
    for s in range(GREEDY):
        tok = jnp.argmax(last, -1)
        greedy.append(np.asarray(tok))
        fwd = jmodel.forward(jc, jp, tok[:, None].astype(jnp.int32),
                             cache=fwd["cache"], mode="decode")
        logits[f"decode{s}"] = jmodel.unembed(jc, jp, fwd["hidden"])
        last = logits[f"decode{s}"][:, -1]
    greedy = np.stack(greedy, 1).astype(np.int32)
    return dict(tc=tc, prompt=prompt, frames=frames, params=params,
                tparams=params_from_numpy(params, device="cpu"),
                enc=np.asarray(enc), xattn=xattn, greedy=greedy,
                steps=[greedy[:, s:s + 1] for s in range(DECODE_STEPS)],
                logits={k: np.asarray(v) for k, v in logits.items()})


def _prefill(r, tp=None):
    tc = r["tc"]
    cache = tkv.init_cache(tc, B, MAX_SEQ, device="cpu")
    fwd = tmodel.forward(tc, tp or r["tparams"],
                         torch.from_numpy(r["prompt"]), cache=cache,
                         mode="prefill",
                         frames=torch.from_numpy(r["frames"]))
    return fwd, cache


# ------------------------------------------------------------------ configs

def test_config_copy_and_counts_match_jax():
    want, got = get_config(ARCH), t_get_config(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for active in (False, True):
        assert tparams.count_params(got, active_only=active) == \
            jparams.count_params(want, active_only=active)
    assert got.param_count() == want.param_count()
    assert dataclasses.asdict(got.smoke()) == dataclasses.asdict(want.smoke())
    # the encoder subtree and the decoder's cross-attention leaves
    defs = tparams.param_defs(got)
    assert defs["encoder"]["blocks"]["p0"]["attn"]["wq"].shape[0] == \
        got.encoder_layers
    assert "xattn" not in defs["encoder"]["blocks"]["p0"]
    assert {"xattn", "xattn_norm"} <= set(defs["blocks"]["p0"])


def test_cache_layout_matches_jax():
    jc, tc = _cfgs()
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jkv.init_cache(jc, B, MAX_SEQ))
    got = jax.tree.map(lambda a: (tuple(a.shape),
                                  str(a.dtype).removeprefix("torch.")),
                       tkv.init_cache(tc, B, MAX_SEQ, device="cpu"))
    assert got == want
    assert got["xattn"]["k"][0] == (tc.num_periods, B, tc.encoder_seq,
                                    tc.num_kv_heads, tc.head_dim)


# ------------------------------------------------------------------- logits

def test_encoder_forward_matches_jax(reference):
    r = reference
    got = tmodel.encoder_forward(r["tc"], r["tparams"],
                                 torch.from_numpy(r["frames"]))
    np.testing.assert_allclose(got.numpy(), r["enc"], rtol=ENC_TOL,
                               atol=ENC_TOL)


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_train_logits_match_jax(reference, impl):
    r = reference
    tc, tp = r["tc"], r["tparams"]
    fwd = tmodel.forward(tc, tp, torch.from_numpy(r["prompt"]),
                         frames=torch.from_numpy(r["frames"]),
                         policy=tmodel.ExecPolicy(impl=impl))
    got = tmodel.unembed(tc, tp, fwd["hidden"])
    assert got.shape == (B, PROMPT, tc.vocab_size)
    np.testing.assert_allclose(got.numpy(), r["logits"]["train"], rtol=TOL,
                               atol=TOL)


def test_prefill_and_decode_logits_match_jax(reference):
    r = reference
    tc, tp = r["tc"], r["tparams"]
    fwd, cache = _prefill(r)
    got = {"prefill": tmodel.unembed(tc, tp, fwd["hidden"])}
    for k in ("k", "v"):
        np.testing.assert_allclose(cache["xattn"][k].numpy(), r["xattn"][k],
                                   rtol=ENC_TOL, atol=ENC_TOL, err_msg=k)
    for s, tok in enumerate(r["steps"]):
        fwd = tmodel.forward(tc, tp, torch.from_numpy(tok), cache=cache,
                             mode="decode")
        got[f"decode{s}"] = tmodel.unembed(tc, tp, fwd["hidden"])
    assert len(got) == 1 + DECODE_STEPS
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), r["logits"][k], rtol=TOL,
                                   atol=TOL, err_msg=k)
    assert cache["pos"].tolist() == [PROMPT + DECODE_STEPS] * B


def test_greedy_transcript_matches_jax(reference):
    r = reference
    tc, tp = r["tc"], r["tparams"]
    fwd, cache = _prefill(r)
    out = []
    for _ in range(GREEDY):
        tok = tmodel.unembed(tc, tp, fwd["hidden"][:, -1]).argmax(-1)
        out.append(tok.numpy())
        fwd = tmodel.forward(tc, tp, tok[:, None].to(torch.int32),
                             cache=cache, mode="decode")
    np.testing.assert_array_equal(np.stack(out, 1), r["greedy"])


def test_decode_reads_the_persisted_cross_kv(reference):
    """After prefill the cross-attention's K and V projections are
    replaced by NaN: decode projects nothing from the encoder again, so
    its logits stay those of the intact weights."""
    r = reference
    tc = r["tc"]
    tp = params_from_numpy(r["params"], device="cpu")
    fwd, cache = _prefill(r, tp)
    for name in ("wk", "wv"):
        tp["blocks"]["p0"]["xattn"][name].fill_(float("nan"))
    fwd = tmodel.forward(tc, tp, torch.from_numpy(r["steps"][0]),
                         cache=cache, mode="decode")
    got = tmodel.unembed(tc, tp, fwd["hidden"])
    np.testing.assert_allclose(got.numpy(), r["logits"]["decode0"],
                               rtol=TOL, atol=TOL)


def test_decode_matches_teacher_forcing(reference):
    """``test_serve_consistency.py``'s invariant on the port alone: the
    prefill and decode logits equal the teacher-forced forward's over the
    whole sequence (positions added at each token's absolute place)."""
    r = reference
    tc, tp = r["tc"], r["tparams"]
    toks = torch.from_numpy(np.concatenate([r["prompt"],
                                            *r["steps"]], axis=1))
    frames = torch.from_numpy(r["frames"])
    full = tmodel.unembed(tc, tp, tmodel.forward(tc, tp, toks,
                                                 frames=frames)["hidden"])
    fwd, cache = _prefill(r)
    np.testing.assert_allclose(
        tmodel.unembed(tc, tp, fwd["hidden"][:, -1]).numpy(),
        full[:, PROMPT - 1].numpy(), rtol=TOL, atol=TOL)
    for s, tok in enumerate(r["steps"]):
        fwd = tmodel.forward(tc, tp, torch.from_numpy(tok), cache=cache,
                             mode="decode")
        np.testing.assert_allclose(
            tmodel.unembed(tc, tp, fwd["hidden"][:, -1]).numpy(),
            full[:, PROMPT + s].numpy(), rtol=TOL, atol=TOL,
            err_msg=f"decode step {s}")


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward_without_frames_raises(reference, mode):
    r = reference
    tc = r["tc"]
    cache = (tkv.init_cache(tc, B, MAX_SEQ, device="cpu")
             if mode == "prefill" else None)
    with pytest.raises(ValueError, match="frames"):
        tmodel.forward(tc, r["tparams"], torch.from_numpy(r["prompt"]),
                       cache=cache, mode=mode)


# ------------------------------------------------------------------ kernels

@pytest.mark.parametrize("S,Skv,kv_cut", [(5, 37, False), (1, 37, False),
                                          (1, 70, True), (20, 6, False)])
def test_flash_prefill_plain_noncausal_matches_pallas(S, Skv, kv_cut):
    """The non-causal form whisper's encoder and cross-attention take:
    S queries against Skv keys, not aligned (one query as in decode, keys
    past a 16-key tile's end, fewer keys than queries), MHA as whisper
    has it; the plain version against the Pallas kernel in interpret
    mode.  With ``kv_cut`` one row sees only part of the keys."""
    Bq, H, Hkv, D = 2, 4, 4, 16
    rng = np.random.default_rng(S * 100 + Skv)
    q = rng.normal(0, 1, (Bq, S, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (Bq, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (Bq, Skv, Hkv, D)).astype(np.float32)
    lens = np.array([Skv, Skv // 2 + 3] if kv_cut else [Skv, Skv], np.int32)
    kw = dict(causal=False, scale=D ** -0.5)
    want = jax_flash.flash_prefill(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), kv_len=jnp.asarray(lens),
                                   block_q=16, block_k=16, interpret=True,
                                   **kw)
    got = ref.flash_prefill_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                torch.from_numpy(lens), **kw)
    assert got.shape == (Bq, S, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # a causal mask would hide keys past each query's own position
    causal = ref.flash_prefill_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                   torch.from_numpy(lens), causal=True,
                                   scale=D ** -0.5)
    assert float((got - causal).abs().max()) > 100 * TOL
