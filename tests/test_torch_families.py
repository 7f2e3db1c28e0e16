"""The attention families gemma2, glm4, olmo and moonshot: the port against
the JAX package on the same weights, in float32 on the CPU.

  * The config copies equal the reference's field for field, and
    ``count_params`` (total and active) agrees on the full configs.
  * Logits of a train forward, a prefill and decode steps within 1e-4 of
    the JAX ``forward``, on each family's ``.smoke()`` and on a variant
    that keeps the family's head ratio (``.smoke()`` cuts ``num_kv_heads``
    to 2 at most): MHA for olmo and moonshot, 16 query heads a KV head for
    glm4, and top-6 of 16 experts for moonshot.  The zero-initialised
    leaves (gemma's (1 + w) norm weights, glm4's QKV biases) are drawn at
    random on both sides, so that their branches count.
  * gemma2's window ring narrower than the sequence: decode against
    teacher forcing, as ``test_serve_consistency.py::
    test_window_ring_overflow_consistency`` holds the reference, and the
    port's decode logits within 1e-4 of the JAX package's at every step.
  * The plain ``flash_prefill_ref`` at gemma2's D = Dv = 256 with a window
    and softcap 50, against the Pallas kernel in interpret mode.
  * The engine against the JAX engine: greedy transcripts, slot histories,
    preemptions, ``kv_traffic()`` and ``weight_traffic()`` equal, for each
    family over the dense ring, gemma2 and glm4 over the block-paged arena
    at r_c 0.25 (gemma2's prompts longer than its window: the window rings
    stay dense, the global layers are paged), and moonshot expert-paged
    at r_w 0.25 in lockstep and in windows.  The JAX engines run with
    their watchdog and degradation ladder off, are built once per module,
    and take the pageable host tier (``offload.pinned_host_sharding``
    patched to None from here, as in ``test_torch_paged.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import offload as jax_offload  # noqa: E402
from repro.kernels import flash_prefill as jax_flash  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402

TOL = 1e-4         # f32 end to end; the two frameworks sum in other orders
ARCHS = ["gemma2-2b", "glm4-9b", "olmo-1b", "moonshot-v1-16b-a3b"]
# the family's head ratio (and moonshot's top-6 routing) on the smoke widths
RATIO = {"glm4-9b": dict(num_heads=16, num_kv_heads=1),
         "olmo-1b": dict(num_kv_heads=4),
         "moonshot-v1-16b-a3b": dict(num_kv_heads=4, num_experts=16,
                                     top_k=6)}
VARIANTS = [(a, "smoke") for a in ARCHS] + [(a, "ratio") for a in RATIO]
MAX_SEQ = 64
PROMPT = 40        # past gemma2's smoke window of 32
DECODE_STEPS = 3


def _cfgs(arch, variant="smoke", **kw):
    extra = {**(RATIO[arch] if variant == "ratio" else {}), **kw}
    return tuple(dataclasses.replace(get(arch).smoke(), dtype="float32",
                                     **extra)
                 for get in (get_config, t_get_config))


def _drawn_params(jc, seed):
    """The JAX package's init, with every norm weight and QKV bias (zeros
    or ones at init) drawn from N(init, 0.1), as numpy."""
    params = jax.tree.map(np.asarray,
                          jparams.init_params(jc, jax.random.key(seed)))
    rng = np.random.default_rng(100 + seed)

    def draw(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                draw(v, path + (k,))
            elif k in ("bq", "bk", "bv") or (k == "scale"
                                              and path[-1].endswith("norm")):
                tree[k] = (v + rng.normal(0, 0.1, v.shape)).astype(v.dtype)
    draw(params, ())
    return params


def test_draws_reach_the_zero_initialised_leaves():
    jc, _ = _cfgs("gemma2-2b")
    p = _drawn_params(jc, 0)
    assert np.abs(p["blocks"]["p0"]["post_attn_norm"]["scale"]).min() > 0
    jc, _ = _cfgs("glm4-9b")
    assert np.abs(_drawn_params(jc, 0)["blocks"]["p0"]["attn"]["bk"]).max() > 0


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_and_counts_match_jax(arch):
    want, got = get_config(arch), t_get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for active in (False, True):
        assert tparams.count_params(got, active_only=active) == \
            jparams.count_params(want, active_only=active)
    assert got.param_count() == want.param_count()
    assert dataclasses.asdict(got.smoke()) == dataclasses.asdict(want.smoke())


# ------------------------------------------------------------------- logits

@pytest.fixture(scope="module")
def reference():
    """Per (arch, variant): both configs, the drawn weights, the seeded
    tokens, and the JAX logits of a train forward, a prefill and
    DECODE_STEPS decode steps."""
    out = {}
    policy = jmodel.ExecPolicy(moe_impl="grouped", use_kernels=False)
    for i, (arch, variant) in enumerate(VARIANTS):
        jc, tc = _cfgs(arch, variant)
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
        out[arch, variant] = dict(
            tc=tc, prompt=prompt, steps=steps,
            tparams=params_from_numpy(params, device="cpu"),
            logits={k: np.asarray(v) for k, v in logits.items()})
    return out


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch,variant", VARIANTS)
def test_forward_logits_match_jax(reference, arch, variant, use_kernels):
    r = reference[arch, variant]
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
        np.testing.assert_allclose(got[k].numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert cache["pos"].tolist() == [PROMPT + DECODE_STEPS] * 2
    if arch == "gemma2-2b":      # the window ring is narrower than the
        assert cache["p0"]["k"].shape[2] == tc.window_size < PROMPT
        assert cache["p1"]["k"].shape[2] == MAX_SEQ          # global ring
        # the final softcap holds every logit inside (-30, 30)
        assert float(got["train"].abs().max()) < tc.logit_softcap


def test_gemma2_window_ring_overflow_matches_jax():
    """A window of 8 under a 20-token prompt and 3 decode steps (the ring
    wraps twice): the port's decode logits equal its teacher-forced
    logits within the reference test's 3e-3, and the JAX package's decode
    logits within 1e-4 at every step."""
    jc, tc = _cfgs("gemma2-2b", window_size=8)
    params = _drawn_params(jc, 2)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, device="cpu")
    B, S, n_dec = 1, 20, 3
    toks = np.random.default_rng(7).integers(
        2, jc.vocab_size, (B, S + n_dec)).astype(np.int32)
    tt = torch.from_numpy(toks)
    full = tmodel.unembed(tc, tp, tmodel.forward(tc, tp, tt)["hidden"])
    jcache = jkv.init_cache(jc, B, S + n_dec + 1, dtype=jnp.float32)
    jcache = jmodel.forward(jc, jp, jnp.asarray(toks[:, :S]), cache=jcache,
                            mode="prefill")["cache"]
    cache = tkv.init_cache(tc, B, S + n_dec + 1, device="cpu")
    tmodel.forward(tc, tp, tt[:, :S], cache=cache, mode="prefill")
    assert cache["p0"]["k"].shape[2] == 8
    for t in range(n_dec):
        out = jmodel.forward(jc, jp, jnp.asarray(toks[:, S + t:S + t + 1]),
                             cache=jcache, mode="decode")
        jcache = out["cache"]
        want = np.asarray(jmodel.unembed(jc, jp, out["hidden"][:, -1]))
        fwd = tmodel.forward(tc, tp, tt[:, S + t:S + t + 1], cache=cache,
                             mode="decode")
        got = tmodel.unembed(tc, tp, fwd["hidden"][:, -1])
        np.testing.assert_allclose(got.numpy(), full[:, S + t].numpy(),
                                   rtol=3e-3, atol=3e-3)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(cache["p0"]["slot_pos"].numpy(),
                                  np.asarray(jcache["p0"]["slot_pos"]))


@pytest.mark.parametrize("S,window,kv_cut", [(48, 20, False),
                                              (40, 0, True)])
def test_flash_prefill_plain_d256_matches_pallas(S, window, kv_cut):
    """gemma2's head width, D = Dv = 256, GQA 4 / 2, softcap 50: the plain
    version (the path a CPU tensor takes through the kernel's wrapper)
    against the Pallas kernel in interpret mode, on rows that see a key.
    q has std 32, so the scores (std 32 at the scale 1/16) reach the
    softcap's saturating region; without the softcap the output moves by
    far more than the tolerance, so the check sees it."""
    B, H, Hkv, D = 2, 4, 2, 256
    rng = np.random.default_rng(S)
    q = rng.normal(0, 32, (B, S, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32)
    lens = (np.array([S, S // 2 + 3], np.int32) if kv_cut
            else np.full((B,), S, np.int32))
    kw = dict(causal=True, window=window, attn_softcap=50.0,
              scale=D ** -0.5)
    want = jax_flash.flash_prefill(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), kv_len=jnp.asarray(lens),
                                   block_q=16, block_k=16, interpret=True,
                                   **kw)
    got = ref.flash_prefill_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                torch.from_numpy(lens), **kw)
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    uncapped = ref.flash_prefill_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(lens),
        **{**kw, "attn_softcap": 0.0})
    assert float((got - uncapped).abs().max()) > 1e3 * TOL


# ------------------------------------------------------------------- engine

LENS = (5, 40, 3, 50, 9, 20)       # two past gemma2's smoke window of 32
QUOTAS = (6, 3, 9, 9, 5, 7)
SLOTS = dict(ubatch=2, num_ubs=2, max_seq=MAX_SEQ, decode_chunk=4)
EXPERT = dict(expert_paged=True, w_gpu_ratio=0.25, page_elems=4096)
# (arch, variant, engine settings)
REGIMES = {
    "gemma2_dense": ("gemma2-2b", "smoke", {}),
    "glm4_dense": ("glm4-9b", "ratio", {}),
    "olmo_dense": ("olmo-1b", "ratio", {}),
    "moonshot_dense": ("moonshot-v1-16b-a3b", "ratio", {}),
    "gemma2_kv025": ("gemma2-2b", "smoke",
                     dict(kv_paged=True, kv_gpu_ratio=0.25)),
    "glm4_kv025": ("glm4-9b", "ratio",
                   dict(kv_paged=True, kv_gpu_ratio=0.25)),
    "moonshot_expert025": ("moonshot-v1-16b-a3b", "ratio", EXPERT),
    "moonshot_expert025_windows": ("moonshot-v1-16b-a3b", "ratio",
                                   {**EXPERT, "module_batch": True}),
}


def _record(eng, rids):
    slots = [s for grp in eng.scheduler.slots for s in grp]
    return dict(
        out={r: list(eng.scheduler.requests[r].generated) for r in rids},
        histories=[s.history for s in slots],
        preemptions=[eng.scheduler.requests[r].preemptions for r in rids],
        kv=eng.kv_traffic(), weights=eng.weight_traffic(),
        tokens_out=eng.tokens_out)


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(2, vocab, n) for n in LENS]


@pytest.fixture(scope="module")
def engine_params():
    """The drawn weights of each (arch, variant) the regimes run."""
    keys = sorted({(a, v) for a, v, _ in REGIMES.values()})
    return {key: _drawn_params(_cfgs(*key)[0], 20 + i)
            for i, key in enumerate(keys)}


@pytest.fixture(scope="module")
def jax_runs(engine_params):
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "pinned_host_sharding", lambda **kw: None)
        for name, (arch, variant, kw) in REGIMES.items():
            jc, _ = _cfgs(arch, variant)
            eng = JaxEngine(
                jc, jax.tree.map(jnp.asarray, engine_params[arch, variant]),
                JaxEngineConfig(**SLOTS, **kw, watchdog=False, degrade=False),
                jmodel.ExecPolicy(moe_impl="grouped", use_kernels=False))
            rids = [eng.submit(p, q)
                    for p, q in zip(_prompts(jc.vocab_size), QUOTAS)]
            eng.run_until_idle()
            runs[name] = _record(eng, rids)
    return runs


@pytest.mark.parametrize("regime", list(REGIMES))
def test_engine_matches_jax(engine_params, jax_runs, regime):
    arch, variant, kw = REGIMES[regime]
    _, tc = _cfgs(arch, variant)
    eng = Engine(tc, params_from_numpy(engine_params[arch, variant],
                                       device="cpu"),
                 EngineConfig(**SLOTS, **kw),
                 tmodel.ExecPolicy(moe_impl="grouped"), device="cpu")
    rids = [eng.submit(p, q) for p, q in zip(_prompts(tc.vocab_size), QUOTAS)]
    eng.run_until_idle()
    got, want = _record(eng, rids), jax_runs[regime]
    assert got == want
    assert all(len(got["out"][r]) == q for r, q in zip(rids, QUOTAS))
    kv, w = got["kv"], got["weights"]
    if kw.get("kv_paged"):
        # the arena spills and preempts; gemma2 pages its global layers only
        assert kv["spills"] > 0 and kv["misses"] > 0
        assert sum(got["preemptions"]) > 0
        assert set(eng._kv_arena) == (
            {"p1"} if arch == "gemma2-2b" else {"p0"})
        eng._kv.check_invariants()
    if kw.get("expert_paged"):
        assert w["mode"] == "expert_paged" and w["misses"] > 0
        assert w["h2d_bytes"] == w["shared_bytes"] + w["expert_bytes"]
        assert (eng._mg == 2) == bool(kw.get("module_batch"))
    if arch == "gemma2-2b":
        # the window rings stay dense, max(LENS) past their width
        assert eng._slot_pool["p0"]["k"].shape[2] == tc.window_size < max(LENS)
