"""The Mamba-2 mixer and the two SSM configs (mamba2-1.3b, jamba-1.5-large):
the port against the JAX package on the same numpy inputs, in float32 on
the CPU.

  * The five tests of ``tests/test_mamba.py``, mirrored: ``ssd_chunked``
    against the recurrence at chunks 4, 16 and 64 at S 37, the state
    carried over two halves, ``ssd_step`` against the chunked scan,
    ``conv_step`` against ``causal_conv``, the mixer's decode against its
    full forward; each also held against the JAX function within 2e-4.
  * The config copies and ``count_params`` (total and active) on the
    full configs, and the SSM cache's leaves against the JAX package's.
  * Logits of a train forward, a prefill and 3 decode steps within 1e-4
    of the JAX ``forward`` on each ``.smoke()``, with every norm weight,
    conv bias, ``a_log``, ``d_skip`` and ``dt_bias`` drawn at random on
    both sides, so that their branches count.
  * Prefill at lengths 13 and 37 inside a bucket of 48: the state and the
    conv tails equal the port's and the JAX package's prefill at each
    prompt's exact width (within 1e-5; jamba's against JAX within 1e-4),
    and the next decode step's logits JAX's within 1e-4.  Without
    ``lens`` the port reproduces the JAX package's padded prefill (whose
    state absorbed the zero tokens), which is what ``lens`` corrects.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = 2e-4         # the SSD units, as tests/test_mamba.py
LOGIT_TOL = 1e-4   # f32 end to end
STATE_TOL = 1e-5   # true-length prefill against exact width
# jamba's true-length prefill against JAX's exact width: its 16 layers of
# f32 sums in two frameworks' orders move the deeper states by up to
# ~1.2e-5 (mamba2's stay under STATE_TOL)
JAMBA_STATE_TOL = 3e-5
ARCHS = ["mamba2-1.3b", "jamba-1.5-large-398b"]
MAX_SEQ = 64
PROMPT = 37        # past the smoke chunk of 16, twice
DECODE_STEPS = 3
DRAWN = ("a_log", "d_skip", "dt_bias", "conv_bx", "conv_bB", "conv_bC")


def _ssd_inputs(seed, b, S, nh, hd, N, dt_scale=0.5):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, S, nh, hd)).astype(np.float32),
            (rng.random((b, S, nh)) * dt_scale + 0.01).astype(np.float32),
            -(rng.random((nh,)) + 0.5).astype(np.float32),
            rng.normal(0, 1, (b, S, N)).astype(np.float32),
            rng.normal(0, 1, (b, S, N)).astype(np.float32))


def _both(args):
    return ([jnp.asarray(a) for a in args],
            [torch.from_numpy(a) for a in args])


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


# --------------------------------------------------------------- SSD units

@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_ssd_chunked_matches_recurrence(chunk):
    ja, ta = _both(_ssd_inputs(chunk, 2, 37, 4, 8, 16))
    y1, s1 = tmamba.ssd_recurrent_ref(*ta)
    y2, s2 = tmamba.ssd_chunked(*ta, chunk=chunk)
    _close(y2, y1)
    _close(s2, s1)
    jy, js = jmamba.ssd_chunked(*ja, chunk=chunk)
    _close(y2, jy)
    _close(s2, js)
    jy, js = jmamba.ssd_recurrent_ref(*ja)
    _close(y1, jy)
    _close(s1, js)


def test_ssd_state_carry():
    """Two halves with the state carried == the whole sequence."""
    args = _ssd_inputs(1, 1, 24, 2, 4, 8, dt_scale=0.3)
    ja, (x, dt, A, B, C) = _both(args)
    y, s = tmamba.ssd_chunked(x, dt, A, B, C, chunk=8)
    h = 24 // 2
    y1, s1 = tmamba.ssd_chunked(x[:, :h], dt[:, :h], A, B[:, :h], C[:, :h],
                                chunk=8)
    y2, s2 = tmamba.ssd_chunked(x[:, h:], dt[:, h:], A, B[:, h:], C[:, h:],
                                state0=s1, chunk=8)
    _close(torch.cat([y1, y2], 1), y)
    _close(s2, s)
    jx, jdt, jA, jB, jC = ja
    _, js1 = jmamba.ssd_chunked(jx[:, :h], jdt[:, :h], jA, jB[:, :h],
                                jC[:, :h], chunk=8)
    jy2, js2 = jmamba.ssd_chunked(jx[:, h:], jdt[:, h:], jA, jB[:, h:],
                                  jC[:, h:], state0=js1, chunk=8)
    _close(y2, jy2)
    _close(s2, js2)


def test_ssd_step_matches_chunked():
    args = _ssd_inputs(2, 1, 10, 2, 4, 8, dt_scale=0.3)
    ja, (x, dt, A, B, C) = _both(args)
    yc, _ = tmamba.ssd_chunked(x, dt, A, B, C, chunk=4)
    s = torch.zeros((1, 2, 4, 8))
    js = jnp.zeros((1, 2, 4, 8), jnp.float32)
    jx, jdt, jA, jB, jC = ja
    for t in range(10):
        yt, s = tmamba.ssd_step(x[:, t], dt[:, t], A, B[:, t], C[:, t], s)
        _close(yt, yc[:, t])
        jyt, js = jmamba.ssd_step(jx[:, t], jdt[:, t], jA, jB[:, t],
                                  jC[:, t], js)
        _close(yt, jyt)
        _close(s, js)


def test_conv_step_matches_causal_conv():
    rng = np.random.default_rng(3)
    B, S, C, cw = 2, 12, 6, 4
    x = rng.normal(0, 1, (B, S, C)).astype(np.float32)
    w = rng.normal(0, 1, (cw, C)).astype(np.float32)
    b = rng.normal(0, 1, (C,)).astype(np.float32)
    full = tmamba.causal_conv(*(torch.from_numpy(a) for a in (x, w, b)))
    _close(full, jmamba.causal_conv(*(jnp.asarray(a) for a in (x, w, b))),
           1e-5)
    cache = torch.zeros((B, cw - 1, C))
    jcache = jnp.zeros((B, cw - 1, C))
    for t in range(S):
        yt, cache = tmamba.conv_step(torch.from_numpy(x[:, t]), cache,
                                     torch.from_numpy(w), torch.from_numpy(b))
        _close(yt, full[:, t], 1e-5)
        jyt, jcache = jmamba.conv_step(jnp.asarray(x[:, t]), jcache,
                                       jnp.asarray(w), jnp.asarray(b))
        _close(yt, jyt, 1e-5)
        _close(cache, jcache, 1e-5)


def test_chunk_mode_raises():
    _, tc = _cfgs("mamba2-1.3b")
    p = tparams.init_params(tc, torch.Generator().manual_seed(0),
                            device="cpu")["blocks"]["p0"]["mamba"]
    with pytest.raises(NotImplementedError):
        tmamba.mamba_forward(tc, {k: v[0] for k, v in p.items()},
                             torch.zeros((1, 4, tc.d_model)), cache=None,
                             mode="chunk")


def test_mamba_forward_decode_matches_full():
    jc, tc = _cfgs("mamba2-1.3b")
    params = _drawn_params(jc, 0)
    np_p = {k: v[0] for k, v in params["blocks"]["p0"]["mamba"].items()}
    jp = {k: jnp.asarray(v) for k, v in np_p.items()}
    tp = params_from_numpy(np_p, device="cpu")
    B, S = 2, 11
    x = np.random.default_rng(4).normal(
        0, 0.5, (B, S, tc.d_model)).astype(np.float32)
    tx = torch.from_numpy(x)
    full = tmamba.mamba_forward(tc, tp, tx, cache=None, mode="full")
    jfull, _ = jmamba.mamba_forward(jc, jp, jnp.asarray(x), cache=None,
                                    mode="full")
    _close(full, jfull)
    cache = {k: v[0] for k, v in tkv._spec_cache(
        tc, tc.period[0], 1, B, 16, torch.float32,
        torch.device("cpu")).items()}
    tmamba.mamba_forward(tc, tp, tx[:, :S - 1], cache=cache, mode="full")
    dec = tmamba.mamba_forward(tc, tp, tx[:, S - 1:], cache=cache,
                               mode="decode")
    _close(dec[:, 0], full[:, -1], 5e-4)
    jcache = jax.tree.map(lambda a: a[0], jkv._spec_cache(
        jc, jc.period[0], 1, B, 16, jnp.float32))
    _, jcache = jmamba.mamba_forward(jc, jp, jnp.asarray(x[:, :S - 1]),
                                     cache=jcache, mode="full")
    jdec, jcache = jmamba.mamba_forward(jc, jp, jnp.asarray(x[:, S - 1:]),
                                        cache=jcache, mode="decode")
    _close(dec, jdec)
    for name in jcache:             # written in place, equal to JAX's
        _close(cache[name], jcache[name], msg=name)


# ------------------------------------------------------------------ configs

def _cfgs(arch, **kw):
    kw = {"dtype": "float32", **kw}
    return tuple(dataclasses.replace(get(arch).smoke(), **kw)
                 for get in (get_config, t_get_config))


def _drawn_params(jc, seed):
    """The JAX package's init as numpy, with every norm weight, conv bias,
    ``a_log``, ``d_skip`` and ``dt_bias`` (zeros or ones at init) drawn
    from N(init, 0.3)."""
    params = jax.tree.map(np.asarray,
                          jparams.init_params(jc, jax.random.key(seed)))
    rng = np.random.default_rng(100 + seed)

    def draw(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                draw(v, path + (k,))
            elif k in DRAWN or (k == "norm" and path[-1] == "mamba") or (
                    k == "scale" and path[-1].endswith("norm")):
                tree[k] = (v + rng.normal(0, 0.3, v.shape)).astype(v.dtype)
    draw(params, ())
    return params


def test_draws_reach_the_constant_leaves():
    jc, _ = _cfgs("jamba-1.5-large-398b")
    fresh = jax.tree.map(np.asarray,
                         jparams.init_params(jc, jax.random.key(0)))
    drawn = _drawn_params(jc, 0)
    for key in ("p0", "p1"):
        for name in DRAWN + ("norm",):
            want = fresh["blocks"][key]["mamba"][name]
            assert np.unique(want).size == 1          # constant at init
            assert np.abs(drawn["blocks"][key]["mamba"][name]
                          - want).min() > 0
        assert np.abs(drawn["blocks"][key]["mamba_norm"]["scale"]
                      - 1).min() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_and_counts_match_jax(arch):
    want, got = get_config(arch), t_get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.smoke()) == dataclasses.asdict(want.smoke())
    for active in (False, True):
        assert tparams.count_params(got, active_only=active) == \
            jparams.count_params(want, active_only=active)
    total = tparams.count_params(got) / 1e9
    active = tparams.count_params(got, active_only=True) / 1e9
    if arch == "mamba2-1.3b":
        assert round(total, 4) == round(active, 4) == 1.3437
    else:
        assert (round(total, 2), round(active, 2)) == (397.71, 93.31)
    # the leaves, their shapes and logical axes, key for key
    assert jax.tree.map(tuple, jparams.param_defs(want),
                        is_leaf=lambda d: isinstance(d, jparams.ParamDef)) \
        == jax.tree.map(tuple, tparams.param_defs(got),
                        is_leaf=lambda d: isinstance(d, tparams.ParamDef))


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_cache_layout_matches_jax(arch):
    jc, tc = _cfgs(arch, dtype="bfloat16")
    want = jkv.init_cache(jc, 3, MAX_SEQ)
    got = tkv.init_cache(tc, 3, MAX_SEQ, device="cpu")
    assert set(got) == set(want)
    for key, group in want.items():
        if key == "pos":
            continue
        assert set(got[key]) == set(group), key
        for name, a in group.items():
            assert tuple(got[key][name].shape) == a.shape, (key, name)
            assert str(got[key][name].dtype).split(".")[1] == str(a.dtype)
    # the SSM positions stay dense: only jamba's attention layer pages
    assert tkv.paged_period_keys(tc) == (
        ("p4",) if arch.startswith("jamba") else ())


# ------------------------------------------------------------------- logits

@pytest.fixture(scope="module")
def reference():
    """Per arch: both configs, the drawn weights, the seeded tokens, and the
    JAX logits of a train forward, a prefill and DECODE_STEPS decode
    steps."""
    out = {}
    policy = jmodel.ExecPolicy(moe_impl="grouped", use_kernels=False)
    for i, arch in enumerate(ARCHS):
        jc, tc = _cfgs(arch)
        params = _drawn_params(jc, i)
        jp = jax.tree.map(jnp.asarray, params)
        rng = np.random.default_rng(10 + i)
        prompt = rng.integers(2, jc.vocab_size, (2, PROMPT)).astype(np.int32)
        steps = rng.integers(2, jc.vocab_size,
                             (DECODE_STEPS, 2, 1)).astype(np.int32)
        fwd = jmodel.forward(jc, jp, jnp.asarray(prompt), policy=policy)
        logits = {"train": jmodel.unembed(jc, jp, fwd["hidden"])}
        fwd = jmodel.forward(jc, jp, jnp.asarray(prompt),
                             cache=jkv.init_cache(jc, 2, MAX_SEQ),
                             mode="prefill", policy=policy)
        logits["prefill"] = jmodel.unembed(jc, jp, fwd["hidden"])
        cache = fwd["cache"]
        for s, tok in enumerate(steps):
            fwd = jmodel.forward(jc, jp, jnp.asarray(tok), cache=cache,
                                 mode="decode", policy=policy)
            logits[f"decode{s}"] = jmodel.unembed(jc, jp, fwd["hidden"])
            cache = fwd["cache"]
        out[arch] = dict(
            jc=jc, tc=tc, jp=jp, prompt=prompt, steps=steps,
            tparams=params_from_numpy(params, device="cpu"),
            logits={k: np.asarray(v) for k, v in logits.items()},
            cache=jax.tree.map(np.asarray, cache))
    return out


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(reference, arch, use_kernels):
    r = reference[arch]
    tc, tp = r["tc"], r["tparams"]
    policy = tmodel.ExecPolicy(moe_impl="grouped", use_kernels=use_kernels)
    prompt = torch.from_numpy(r["prompt"])
    got = {"train": tmodel.unembed(tc, tp, tmodel.forward(
        tc, tp, prompt, policy=policy)["hidden"])}
    cache = tkv.init_cache(tc, 2, MAX_SEQ, device="cpu")
    fwd = tmodel.forward(tc, tp, prompt, cache=cache, mode="prefill",
                         policy=policy)
    got["prefill"] = tmodel.unembed(tc, tp, fwd["hidden"])
    for s, tok in enumerate(r["steps"]):
        fwd = tmodel.forward(tc, tp, torch.from_numpy(tok), cache=cache,
                             mode="decode", policy=policy)
        got[f"decode{s}"] = tmodel.unembed(tc, tp, fwd["hidden"])
    assert set(got) == set(r["logits"])
    for k, want in r["logits"].items():
        _close(got[k], want, LOGIT_TOL, k)
    assert cache["pos"].tolist() == [PROMPT + DECODE_STEPS] * 2
    for key, group in r["cache"].items():        # every leaf, in place
        if key != "pos":
            for name, want in group.items():
                _close(cache[key][name], want, LOGIT_TOL, f"{key}/{name}")


def _ssm_leaves(cache):
    return {(k, n): np.array(a) for k, g in cache.items() if k != "pos"
            for n, a in g.items() if n.startswith("conv") or n == "state"}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_true_length_matches_exact_width(reference, arch):
    """Rows of 13 and 37 tokens prefilled together at width 48 (the
    engine's bucket of 37; 13 is a shorter row of a static micro-batch):
    each row's SSM state and conv tails equal the port's prefill of that
    prompt alone at its exact width within 1e-5, and the JAX package's
    within 1e-5 (mamba2) or 3e-5 (jamba), and the next decode step's
    logits equal JAX's within 1e-4.  Without lens the port equals the JAX
    package's own padded prefill, whose state the zero tokens moved."""
    r = reference[arch]
    jc, tc, jp, tp = r["jc"], r["tc"], r["jp"], r["tparams"]
    lens, width = (13, 37), 48
    jax_tol = STATE_TOL if arch == "mamba2-1.3b" else JAMBA_STATE_TOL
    rng = np.random.default_rng(20)
    toks = np.zeros((2, width), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(2, jc.vocab_size, n)
    nxt = rng.integers(2, jc.vocab_size, (2, 1)).astype(np.int32)
    policy = tmodel.ExecPolicy(moe_impl="dense")
    jpolicy = jmodel.ExecPolicy(moe_impl="dense")
    cache = tkv.init_cache(tc, 2, MAX_SEQ, device="cpu")
    tmodel.forward(tc, tp, torch.from_numpy(toks), cache=cache,
                   mode="prefill", policy=policy,
                   lens=torch.tensor(lens, dtype=torch.int32))
    prefilled = _ssm_leaves(cache)                # before decode moves it
    cache["pos"] = torch.tensor(lens, dtype=torch.int32)
    dec = tmodel.unembed(tc, tp, tmodel.forward(
        tc, tp, torch.from_numpy(nxt), cache=cache, mode="decode",
        policy=policy)["hidden"][:, -1])
    padded = tkv.init_cache(tc, 2, MAX_SEQ, device="cpu")
    tmodel.forward(tc, tp, torch.from_numpy(toks), cache=padded,
                   mode="prefill", policy=policy)
    jpadded = jmodel.forward(jc, jp, jnp.asarray(toks),
                             cache=jkv.init_cache(jc, 2, MAX_SEQ),
                             mode="prefill", policy=jpolicy)["cache"]
    for i, n in enumerate(lens):
        jcache = jmodel.forward(jc, jp, jnp.asarray(toks[i:i + 1, :n]),
                                cache=jkv.init_cache(jc, 1, MAX_SEQ),
                                mode="prefill", policy=jpolicy)["cache"]
        want = _ssm_leaves(jcache)
        got = {k: v[:, i:i + 1] for k, v in prefilled.items()}
        assert set(got) == set(want) and want
        exact = tkv.init_cache(tc, 1, MAX_SEQ, device="cpu")
        tmodel.forward(tc, tp, torch.from_numpy(toks[i:i + 1, :n]),
                       cache=exact, mode="prefill", policy=policy)
        for k, v in _ssm_leaves(exact).items():
            _close(got[k], v, STATE_TOL, f"row {i} {k} vs the port")
            _close(got[k], want[k], jax_tol, f"row {i} {k} vs JAX")
        jdec = jmodel.forward(jc, jp, jnp.asarray(nxt[i:i + 1]),
                              cache=jcache, mode="decode", policy=jpolicy)
        _close(dec[i:i + 1], jmodel.unembed(jc, jp, jdec["hidden"][:, -1]),
               LOGIT_TOL, f"row {i} decode")
        # the padded prefill is the JAX package's, and the padding moved it
        pad_got = {k: v[:, i:i + 1] for k, v in _ssm_leaves(padded).items()}
        pad_want = {k: v[:, i:i + 1] for k, v in
                    _ssm_leaves(jpadded).items()}
        for k in want:
            _close(pad_got[k], pad_want[k], LOGIT_TOL, f"padded {k}")
        assert max(np.abs(pad_got[k] - want[k]).max() for k in want) > 1e-2
