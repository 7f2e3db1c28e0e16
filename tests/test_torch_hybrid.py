"""The port's engine on the two SSM configs (mamba2-1.3b, jamba-1.5-large)
against the JAX package, in float32 on the CPU.

  * Against the JAX engine: greedy transcripts, slot histories,
    preemptions, ``kv_traffic()`` and ``weight_traffic()`` equal, for
    mamba2 and jamba over the dense ring in lockstep and in windows, jamba
    in static mode, jamba over the block-paged arena at r_c 0.3 (its
    attention layer paged, the SSM states dense), jamba expert-paged at
    r_w 0.25 (its four MoE positions only) and jamba on whole-layer paged
    weights.  In these regimes every prompt length is a multiple of 16,
    every static group's prompts are equally long and nothing is
    preempted (the arena at r_c 0.25 would preempt): these are the only
    conditions under which the JAX engine's SSM state is right, because
    it prefills a prompt padded to its bucket (or to its group's longest)
    and its mixer carries the state and the conv tails from the padded
    end.  The next group of tests covers the other lengths.
  * Prompts of 13, 29 and 45 tokens in continuous mode, in static mode and
    under EWMA reservations that preempt: each request's transcript equals
    greedy decoding by the JAX ``forward`` at the prompt's exact width
    (jamba with the dense MoE, whose result does not depend on which rows
    share a batch).  The port prefills at each row's true length.
  * ``overlap=True``, ``kv_paged`` on mamba2 and ``expert_paged`` on
    mamba2 each raise the JAX engine's error.

jamba runs one period (8 layers) of its ``.smoke()``.  The JAX engines run
with their watchdog and degradation ladder off, are built once per module,
and take the pageable host tier (``offload.pinned_host_sharding`` patched
to None from here, as in ``test_torch_paged.py``).
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
from repro.models import kvcache as jkv  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402

MAMBA2, JAMBA = "mamba2-1.3b", "jamba-1.5-large-398b"
MAX_SEQ = 96
SLOTS = dict(ubatch=2, num_ubs=2, max_seq=MAX_SEQ, decode_chunk=4)
LENS = (16, 32, 16, 32, 32, 16)    # multiples of 16: the JAX engine's
QUOTAS = (6, 3, 9, 9, 5, 7)
STATIC_LENS = (32,) * 6            # equal-length static groups
# (arch, engine settings, prompt lengths)
REGIMES = {
    "mamba2_ring": (MAMBA2, {}, LENS),
    "mamba2_windows": (MAMBA2, dict(module_batch=True), LENS),
    "jamba_ring": (JAMBA, {}, LENS),
    "jamba_windows": (JAMBA, dict(module_batch=True), LENS),
    "jamba_static": (JAMBA, dict(mode="static"), STATIC_LENS),
    "jamba_kv030": (JAMBA, dict(kv_paged=True, kv_gpu_ratio=0.3,
                                block_tokens=8), LENS),
    "jamba_expert025": (JAMBA, dict(expert_paged=True, w_gpu_ratio=0.25,
                                    page_elems=4096), LENS),
    "jamba_paged": (JAMBA, dict(paged=True, page_elems=4096), LENS),
}


def _cfgs(arch):
    kw = {"dtype": "float32"}
    if arch == JAMBA:
        kw["num_layers"] = 8                     # one period
    return tuple(dataclasses.replace(get(arch).smoke(), **kw)
                 for get in (get_config, t_get_config))


def _drawn_params(jc, seed):
    """The JAX package's init as numpy, with the mixers' constant leaves
    (``a_log``, ``d_skip``, ``dt_bias``, conv biases, gated norm) and every
    norm weight drawn from N(init, 0.3), so that their branches count."""
    params = jax.tree.map(np.asarray,
                          jparams.init_params(jc, jax.random.key(seed)))
    rng = np.random.default_rng(100 + seed)

    def draw(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                draw(v, path + (k,))
            elif path and path[-1] == "mamba" and v.ndim == 2 \
                    or k == "scale":
                tree[k] = (v + rng.normal(0, 0.3, v.shape)).astype(v.dtype)
    draw(params, ())
    return params


def _prompts(vocab, lens, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, n) for n in lens]


def _record(eng, rids):
    slots = [s for grp in eng.scheduler.slots for s in grp]
    return dict(
        out={r: list(eng.scheduler.requests[r].generated) for r in rids},
        histories=[s.history for s in slots],
        preemptions=[eng.scheduler.requests[r].preemptions for r in rids],
        kv=eng.kv_traffic(), weights=eng.weight_traffic(),
        tokens_out=eng.tokens_out)


@pytest.fixture(scope="module")
def weights():
    return {arch: _drawn_params(_cfgs(arch)[0], i + 1)
            for i, arch in enumerate((MAMBA2, JAMBA))}


@pytest.fixture(scope="module")
def jax_runs(weights):
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "pinned_host_sharding", lambda **kw: None)
        for name, (arch, kw, lens) in REGIMES.items():
            jc, _ = _cfgs(arch)
            eng = JaxEngine(
                jc, jax.tree.map(jnp.asarray, weights[arch]),
                JaxEngineConfig(**SLOTS, **kw, watchdog=False, degrade=False),
                jmodel.ExecPolicy(moe_impl="grouped", use_kernels=False))
            rids = [eng.submit(p, q) for p, q in
                    zip(_prompts(jc.vocab_size, lens), QUOTAS)]
            eng.run_until_idle()
            runs[name] = _record(eng, rids)
    return runs


@pytest.mark.parametrize("regime", list(REGIMES))
def test_engine_matches_jax(weights, jax_runs, regime):
    arch, kw, lens = REGIMES[regime]
    _, tc = _cfgs(arch)
    eng = Engine(tc, params_from_numpy(weights[arch], device="cpu"),
                 EngineConfig(**SLOTS, **kw),
                 tmodel.ExecPolicy(moe_impl="grouped"), device="cpu")
    rids = [eng.submit(p, q)
            for p, q in zip(_prompts(tc.vocab_size, lens), QUOTAS)]
    eng.run_until_idle()
    got, want = _record(eng, rids), jax_runs[regime]
    assert got == want
    assert sum(got["preemptions"]) == 0
    kv, w = got["kv"], got["weights"]
    if kw.get("kv_paged"):
        # the attention position pages and spills; the SSM states stay
        # dense in the slot pool
        assert set(eng._kv_arena) == {"p4"} and kv["spills"] > 0
        assert "state" in eng._slot_pool["p0"]
        eng._kv.check_invariants()
    if kw.get("expert_paged"):
        # only the MoE positions have expert spans; the mixers, the dense
        # FFNs and the attention layer stream as shared spans
        assert set(eng.paged_blocks.expert_manifests) == \
            {"p1", "p3", "p5", "p7"}
        assert set(eng.paged_blocks.pages) == {f"p{i}" for i in range(8)}
        assert w["mode"] == "expert_paged" and w["misses"] > 0
    if kw.get("module_batch"):
        assert eng._mg == 2


# -------------------------------------------- prompts of any length

ODD_LENS = (13, 29, 45)          # no multiple of 16; each prompt sent twice
ODD_QUOTAS = (2, 12, 2, 12, 2, 12)   # short ones first: the EWMA learns 2
ODD_REGIMES = {
    "continuous": {},
    "windows": dict(module_batch=True),
    "static": dict(mode="static"),
    "ewma_preempt": dict(reserve_mode="ewma", cache_tokens=80),
}


@pytest.fixture(scope="module")
def teacher(weights):
    """Per arch: each ODD_LENS prompt's greedy transcript of max(quota)
    tokens from the JAX ``forward``, prefilled at the prompt's exact width
    and decoded a token at a time (dense MoE)."""
    out = {}
    policy = jmodel.ExecPolicy(moe_impl="dense", use_kernels=False)
    for arch in (MAMBA2, JAMBA):
        jc, _ = _cfgs(arch)
        jp = jax.tree.map(jnp.asarray, weights[arch])
        decode = jax.jit(lambda p, tok, cache: jmodel.forward(
            jc, p, tok, cache=cache, mode="decode", policy=policy))
        runs = []
        for prompt in _prompts(jc.vocab_size, ODD_LENS, seed=7):
            fwd = jmodel.forward(jc, jp, jnp.asarray(prompt[None]),
                                 cache=jkv.init_cache(jc, 1, MAX_SEQ),
                                 mode="prefill", policy=policy)
            toks = []
            for _ in range(max(ODD_QUOTAS)):
                logits = jmodel.unembed(jc, jp, fwd["hidden"][:, -1])
                toks.append(int(jnp.argmax(logits[0])))
                fwd = decode(jp, jnp.asarray([[toks[-1]]], jnp.int32),
                             fwd["cache"])
            runs.append(toks)
        out[arch] = runs
    return out


@pytest.mark.parametrize("regime", list(ODD_REGIMES))
@pytest.mark.parametrize("arch", [MAMBA2, JAMBA])
def test_any_length_matches_exact_width_greedy(weights, teacher, arch,
                                               regime):
    kw = ODD_REGIMES[regime]
    _, tc = _cfgs(arch)
    eng = Engine(tc, params_from_numpy(weights[arch], device="cpu"),
                 EngineConfig(**SLOTS, **kw),
                 tmodel.ExecPolicy(moe_impl="dense"), device="cpu")
    prompts = _prompts(tc.vocab_size, ODD_LENS, seed=7) * 2
    rids = [eng.submit(p, q) for p, q in zip(prompts, ODD_QUOTAS)]
    eng.run_until_idle()
    eos = eng.ecfg.eos_id
    for rid, want, q in zip(rids, teacher[arch] * 2, ODD_QUOTAS):
        got = eng.scheduler.requests[rid].generated
        assert len(got) == q or got[-1] == eos
        assert got == want[:len(got)], rid
    preempted = sum(eng.scheduler.requests[r].preemptions for r in rids)
    # the EWMA budget preempts: those requests recompute prompt +
    # transcript, prefilled at its true length too
    assert (preempted > 0) == (regime == "ewma_preempt")


# ------------------------------------------------------------------- gates

@pytest.mark.parametrize("kw,match", [
    (dict(overlap=True), "attention-only configs"),
    (dict(kv_paged=True), "full-attention kv/mla period position"),
    (dict(expert_paged=True), "requires a MoE config"),
])
def test_mamba2_gates_raise_the_reference_error(weights, kw, match):
    jc, tc = _cfgs(MAMBA2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "pinned_host_sharding", lambda **kw: None)
        with pytest.raises(ValueError, match=match):
            JaxEngine(jc, jax.tree.map(jnp.asarray, weights[MAMBA2]),
                      JaxEngineConfig(**SLOTS, **kw, watchdog=False,
                                      degrade=False))
    with pytest.raises(ValueError, match=match):
        Engine(tc, params_from_numpy(weights[MAMBA2], device="cpu"),
               EngineConfig(**SLOTS, **kw), device="cpu")
