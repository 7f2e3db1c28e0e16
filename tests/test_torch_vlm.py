"""paligemma-3b's patch prefix and ``models/inputs.py``: the port against
the JAX package on the same weights, in float32 on the CPU at
``.smoke()`` (2 layers, 16 vision tokens, head_dim 16, one KV head).

  * The config copy equals the reference's field for field, and
    ``count_params`` (total and active) agrees on the full config
    (arithmetic on the parameter definitions; nothing is allocated).
  * ``input_specs`` gives the reference's shapes and dtypes as meta
    tensors, and ``concrete_inputs`` the reference's arrays from one seed,
    for paligemma and whisper at a train, a prefill and a decode shape.
  * Logits with the patch prefix of a train forward, a prefill and 4
    decode steps within 1e-4 of the JAX ``forward`` plus ``unembed``, on
    a prompt longer than the prefix and on one shorter than it; the
    prefix moves the text positions' logits.
  * An 8-token greedy transcript after a prefix prefill, equal to the JAX
    package's (the decode steps above are its first 4, fed the JAX
    transcript's tokens).
  * Text only, through both packages' engines (over the dense ring and
    over the block-paged arena at r_c 0.25): greedy transcripts, slot
    histories, preemptions and ``kv_traffic()`` equal.

gemma's (1 + w) norm weights (zeros at init) are drawn at random on both
sides, so that their branch counts.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES, get_config  # noqa: E402
from repro.core import offload as jax_offload  # noqa: E402
from repro.models import inputs as jinputs  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import inputs as tinputs  # noqa: E402
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402

ARCH = "paligemma-3b"
TOL = 1e-4         # f32 logits end to end
B, DECODE_STEPS, GREEDY, MAX_SEQ = 2, 4, 8, 64
PROMPTS = {"long": 28, "short": 10}     # past and within the 16-token prefix


def _cfgs():
    return tuple(dataclasses.replace(get(ARCH).smoke(), dtype="float32")
                 for get in (get_config, t_get_config))


def _drawn_params(jc, seed):
    """The JAX package's init as numpy, every norm weight drawn from
    N(init, 0.1)."""
    params = jax.tree.map(np.asarray,
                          jparams.init_params(jc, jax.random.key(seed)))
    rng = np.random.default_rng(100 + seed)

    def draw(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                draw(v, path + (k,))
            elif path[-1].endswith("norm"):
                tree[k] = (v + rng.normal(0, 0.1, v.shape)).astype(v.dtype)
    draw(params, ())
    return params


@pytest.fixture(scope="module")
def reference():
    """Both configs, the drawn weights, and per prompt length the seeded
    tokens and patches, the JAX logits of a train forward (with and
    without the prefix), of a prefill, and of GREEDY decode steps, each
    fed the argmax of the step before (the greedy transcript)."""
    jc, tc = _cfgs()
    params = _drawn_params(jc, 0)
    jp = jax.tree.map(jnp.asarray, params)
    out = dict(tc=tc, params=params,
               tparams=params_from_numpy(params, device="cpu"))
    for i, (label, S) in enumerate(PROMPTS.items()):
        rng = np.random.default_rng(10 + i)
        prompt = rng.integers(2, jc.vocab_size, (B, S)).astype(np.int32)
        patches = rng.normal(0, 1, (B, jc.vision_tokens, jc.d_model)
                             ).astype(np.float32)
        jpt = jnp.asarray(patches)
        logits = {"train": jmodel.unembed(jc, jp, jmodel.forward(
            jc, jp, jnp.asarray(prompt), patches=jpt)["hidden"])}
        text_only = jmodel.unembed(jc, jp, jmodel.forward(
            jc, jp, jnp.asarray(prompt))["hidden"])
        fwd = jmodel.forward(jc, jp, jnp.asarray(prompt),
                             cache=jkv.init_cache(jc, B, MAX_SEQ),
                             mode="prefill", patches=jpt)
        logits["prefill"] = jmodel.unembed(jc, jp, fwd["hidden"])
        last, greedy = logits["prefill"][:, -1], []
        for s in range(GREEDY):
            tok = jnp.argmax(last, -1)
            greedy.append(np.asarray(tok))
            fwd = jmodel.forward(jc, jp, tok[:, None].astype(jnp.int32),
                                 cache=fwd["cache"], mode="decode")
            logits[f"decode{s}"] = jmodel.unembed(jc, jp, fwd["hidden"])
            last = logits[f"decode{s}"][:, -1]
        out[label] = dict(
            prompt=prompt, patches=patches,
            logits={k: np.asarray(v) for k, v in logits.items()},
            text_only=np.asarray(text_only), greedy=np.stack(greedy, 1))
    return out


# ------------------------------------------------------------------ configs

def test_config_copy_and_counts_match_jax():
    want, got = get_config(ARCH), t_get_config(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for active in (False, True):
        assert tparams.count_params(got, active_only=active) == \
            jparams.count_params(want, active_only=active)
    assert got.param_count() == want.param_count()
    assert dataclasses.asdict(got.smoke()) == dataclasses.asdict(want.smoke())


# ------------------------------------------------------------------- inputs

SHAPE_CASES = [(a, s) for a in (ARCH, "whisper-small")
               for s in ("train_4k", "prefill_32k", "decode_32k")]


@pytest.mark.parametrize("arch,shape", SHAPE_CASES)
def test_input_specs_match_jax(arch, shape):
    """The full configs at the full shapes: meta tensors, no storage."""
    want = jinputs.input_specs(get_config(arch), SHAPES[shape])
    got = tinputs.input_specs(t_get_config(arch), T_SHAPES[shape])
    assert list(got) == list(want)
    flat_want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), want)
    flat_got = jax.tree.map(lambda t: (tuple(t.shape),
                                       str(t.dtype).removeprefix("torch.")),
                            got)
    assert flat_got == flat_want
    assert all(t.device.type == "meta" for t in jax.tree.leaves(got))


@pytest.mark.parametrize("arch,shape", SHAPE_CASES)
def test_concrete_inputs_match_jax(arch, shape):
    """One seed gives both packages the same arrays (at the smoke sizes,
    in the configs' bf16)."""
    jc, tc = get_config(arch).smoke(), t_get_config(arch).smoke()
    want = jinputs.concrete_inputs(jc, SHAPES[shape].smoke(), seed=7)
    got = tinputs.concrete_inputs(tc, T_SHAPES[shape].smoke(), seed=7,
                                  device="cpu")
    assert list(got) == list(want)
    if SHAPES[shape].mode != "decode":
        assert ("frames" if jc.encoder_layers else "patches") in got
    for name, w in want.items():
        if name == "cache":
            g = jax.tree.map(lambda t: t.float().numpy(), got[name])
            w = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), w)
            assert jax.tree.structure(g) == jax.tree.structure(w)
            for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
                np.testing.assert_array_equal(a, b)
            continue
        assert str(got[name].dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(
            got[name].float().numpy(), np.asarray(w.astype(jnp.float32)),
            err_msg=name)


# ------------------------------------------------------------------- logits

@pytest.mark.parametrize("label", list(PROMPTS))
def test_prefix_logits_match_jax(reference, label):
    r, tc, tp = reference[label], reference["tc"], reference["tparams"]
    prompt, patches = torch.from_numpy(r["prompt"]), \
        torch.from_numpy(r["patches"])
    got = {"train": tmodel.unembed(tc, tp, tmodel.forward(
        tc, tp, prompt, patches=patches)["hidden"])}
    cache = tkv.init_cache(tc, B, MAX_SEQ, device="cpu")
    fwd = tmodel.forward(tc, tp, prompt, cache=cache, mode="prefill",
                         patches=patches)
    got["prefill"] = tmodel.unembed(tc, tp, fwd["hidden"])
    for s in range(DECODE_STEPS):     # fed the JAX transcript's tokens
        tok = torch.from_numpy(r["greedy"][:, s:s + 1].astype(np.int32))
        fwd = tmodel.forward(tc, tp, tok, cache=cache, mode="decode")
        got[f"decode{s}"] = tmodel.unembed(tc, tp, fwd["hidden"])
    assert len(got) == 2 + DECODE_STEPS
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), r["logits"][k], rtol=TOL,
                                   atol=TOL, err_msg=k)


@pytest.mark.parametrize("label", list(PROMPTS))
def test_prefix_moves_text_logits(reference, label):
    """Text only, the port's logits equal the JAX package's; the prefix
    moves them at every position, past it too (the text attends to it)."""
    r, tc, tp = reference[label], reference["tc"], reference["tparams"]
    text = tmodel.unembed(tc, tp, tmodel.forward(
        tc, tp, torch.from_numpy(r["prompt"]))["hidden"])
    np.testing.assert_allclose(text.numpy(), r["text_only"], rtol=TOL,
                               atol=TOL)
    moved = np.abs(r["logits"]["train"] - text.numpy()).max(-1)   # (B, S)
    assert moved.min() > 1e3 * TOL
    nv = tc.vision_tokens
    if r["prompt"].shape[1] > nv:
        assert moved[:, nv:].min() > 1e3 * TOL


@pytest.mark.parametrize("label", list(PROMPTS))
def test_greedy_transcript_matches_jax(reference, label):
    r, tc, tp = reference[label], reference["tc"], reference["tparams"]
    cache = tkv.init_cache(tc, B, MAX_SEQ, device="cpu")
    fwd = tmodel.forward(tc, tp, torch.from_numpy(r["prompt"]), cache=cache,
                         mode="prefill",
                         patches=torch.from_numpy(r["patches"]))
    out = []
    for _ in range(GREEDY):
        tok = tmodel.unembed(tc, tp, fwd["hidden"][:, -1]).argmax(-1)
        out.append(tok.numpy())
        fwd = tmodel.forward(tc, tp, tok[:, None].to(torch.int32),
                             cache=cache, mode="decode")
    np.testing.assert_array_equal(np.stack(out, 1), r["greedy"])


# ------------------------------------------------------------------- engine

LENS = (5, 40, 3, 20, 9, 30)
QUOTAS = (6, 3, 9, 9, 5, 7)
SLOTS = dict(ubatch=2, num_ubs=2, max_seq=MAX_SEQ, decode_chunk=4)
REGIMES = {"dense": {}, "kv025": dict(kv_paged=True, kv_gpu_ratio=0.25)}


def _record(eng, rids):
    slots = [s for grp in eng.scheduler.slots for s in grp]
    return dict(
        out={r: list(eng.scheduler.requests[r].generated) for r in rids},
        histories=[s.history for s in slots],
        preemptions=[eng.scheduler.requests[r].preemptions for r in rids],
        kv=eng.kv_traffic(), tokens_out=eng.tokens_out)


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(2, vocab, n) for n in LENS]


@pytest.fixture(scope="module")
def jax_runs(reference):
    jc, _ = _cfgs()
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "pinned_host_sharding", lambda **kw: None)
        for name, kw in REGIMES.items():
            eng = JaxEngine(
                jc, jax.tree.map(jnp.asarray, reference["params"]),
                JaxEngineConfig(**SLOTS, **kw, watchdog=False, degrade=False),
                jmodel.ExecPolicy(use_kernels=False))
            rids = [eng.submit(p, q)
                    for p, q in zip(_prompts(jc.vocab_size), QUOTAS)]
            eng.run_until_idle()
            runs[name] = _record(eng, rids)
    return runs


@pytest.mark.parametrize("regime", list(REGIMES))
def test_text_only_engine_matches_jax(reference, jax_runs, regime):
    tc = reference["tc"]
    kw = REGIMES[regime]
    eng = Engine(tc, params_from_numpy(reference["params"], device="cpu"),
                 EngineConfig(**SLOTS, **kw), tmodel.ExecPolicy(),
                 device="cpu")
    rids = [eng.submit(p, q) for p, q in zip(_prompts(tc.vocab_size), QUOTAS)]
    eng.run_until_idle()
    got, want = _record(eng, rids), jax_runs[regime]
    assert got == want
    assert all(len(got["out"][r]) == q for r, q in zip(rids, QUOTAS))
    if kw.get("kv_paged"):
        assert got["kv"]["spills"] > 0 and got["kv"]["misses"] > 0
        eng._kv.check_invariants()
