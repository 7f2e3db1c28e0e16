"""The port's distributed layer against the JAX package's single-device
functions, in real process groups on the CPU.

``tests/torch_dist_worker.py`` runs each case in every rank of a gloo
group (``init_method="file://..."``: nothing in this process's
environment changes); the inputs come from numpy with a seed, the
references from the JAX package in this process.

At 2 ranks:
  * ``lse_combine`` of each half-ring's partials, and
    ``make_seq_sharded_attn`` over the ring split in halves (one row's
    second half holds no valid key, another row's first half), equal the
    reference's ``combine_partials(attention_partials(...))`` over the
    whole ring within 1e-5, with and without a softcap.
  * The expert-parallel bodies (capacity factor 8.0: no token dropped)
    equal the reference's ``moe.moe_dense`` within 2e-4: ``ep_psum`` with
    4 experts a rank (mixtral; deepseek, whose shared expert enters the
    sum divided by the expert shards) and with each expert's FFN dim over
    'data' (``ffn_axes``), ``ep_a2a`` with 4 experts a rank.  aux within
    1e-3: the whole batch's for ``ep_psum`` (tokens replicated), the mean
    of the ranks' router losses on their token slices for ``ep_a2a`` (the
    reference's ``pmean`` of local auxes).
  * ``compressed_psum`` int8 / bf16 / plain: sum plus both ranks' residuals
    equals the exact sum; error feedback telescopes over 20 steps;
    ``tree_compressed_psum`` keeps the tree.
  * ``restore_elastic`` gives each rank of a (1, 2) mesh its block of a
    checkpoint written whole, under the reference's plan for that mesh.
At 1 rank:
  * ``make_serve_step`` (greedy, 4 steps after a prefill) under a mixtral
    ``.smoke()`` plan equals the reference's ``make_serve_step``: f32
    logits within 1e-4 and the same tokens.  The ("model",) plan
    (``ep_psum`` + the sequence-sharded attention) against the reference
    under its own plan on ``jax.make_mesh((1,), ("model",))`` and without
    one; the ("data", "model") plan (the grouped MoE + the sequence-sharded
    attention) against the reference without a plan only: under JAX 0.9
    the reference's (1, 1) plan does not run (its sequence-sharded
    attention's ``shard_map`` finds no 'data' axis in the mesh).
  * A train step under the ("model",) train plan (``ep_a2a``), with
    ``remat`` on and off, equals the reference's ``make_train_step``
    (``test_torch_train.py``'s tolerances): the reference's own ``ep_a2a``
    cannot run under JAX 0.9 (``test_moe.py``'s ``ep_a2a`` case fails with
    a ``ShardingTypeError``), so its step runs the dense MoE.
  * The unit-mesh mirror of ``test_moe.py::
    test_ep_bodies_match_dense_on_unit_mesh``: ``ep_psum`` against the
    reference's shard fn, ``ep_a2a`` against ``moe_dense``; and
    ``test_compression.py``'s tests at one rank.
  * ``launch.train`` joins the launcher's group from ``RANK`` /
    ``WORLD_SIZE`` (gloo on the CPU, in a subprocess).
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_shape as j_get_shape  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.models import kvcache as j_kvcache  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.attention import attention_partials  # noqa: E402
from repro.models.attention import combine_partials  # noqa: E402
from repro.models.model import forward as j_forward  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.serving.steps import make_serve_step as j_serve_step  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    dequantize_int8, quantize_int8)
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from test_torch_train import _batch, assert_step_matches  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_dist_worker.py"
ATTN_TOL, MOE_TOL, AUX_TOL, LOGIT_TOL = 1e-5, 2e-4, 1e-3, 1e-4
B, H, HKV, D, W = 3, 4, 2, 16, 16
SERVE_B, SERVE_S, SERVE_STEPS = 4, 12, 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg(arch, **kw):
    return dataclasses.replace(j_get_config(arch).smoke(), dtype="float32",
                               **kw)


def _moe_layer(cfg, key=0):
    return _np(jax.tree.map(lambda a: a[0], init_params(
        cfg, jax.random.key(key))["blocks"]["p0"]["moe"]))


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_t(v) for v in tree]
    return torch.from_numpy(np.array(tree))


# ------------------------------------------------------------- the inputs

def _attn_inputs():
    rng = np.random.default_rng(0)
    q = rng.normal(0, 1, (B, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, W, HKV, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, W, HKV, D)).astype(np.float32)
    valid = rng.random((B, W)) < 0.7
    valid[0, W // 2:] = False          # row 0: its second half is empty
    valid[2, :W // 2] = False          # row 2: its first half is empty
    valid[:, 0] |= np.arange(B) != 2
    valid[2, W - 1] = True
    return dict(q=q, k=k, v=v, valid=valid, scale=D ** -0.5,
                softcaps=[0.0, 5.0])


def _attn_ref(a, softcap):
    o, m, l = attention_partials(jnp.asarray(a["q"]), jnp.asarray(a["k"]),
                                 jnp.asarray(a["v"]),
                                 jnp.asarray(a["valid"]), scale=a["scale"],
                                 attn_softcap=softcap)
    return np.asarray(combine_partials(o, m, l))


def _half_partials(a):
    """The reference's partials of each half of the ring."""
    parts = [attention_partials(
        jnp.asarray(a["q"]), jnp.asarray(a["k"][:, s]),
        jnp.asarray(a["v"][:, s]), jnp.asarray(a["valid"][:, s]),
        scale=a["scale"]) for s in (slice(0, W // 2), slice(W // 2, W))]
    return {n: [torch.from_numpy(np.array(p[i])) for p in parts]
            for i, n in enumerate(("o", "m", "l"))}


EP_CASES = {
    # name: (arch, variant, (mesh sizes, names), expert axes, ffn axes)
    "psum_mixtral": ("mixtral-8x7b", "ep_psum", ((2,), ("model",)),
                     ("model",), ()),
    "psum_deepseek": ("deepseek-v3-671b", "ep_psum", ((2,), ("model",)),
                      ("model",), ()),
    "psum_deepseek_ffn": ("deepseek-v3-671b", "ep_psum",
                          ((2, 1), ("data", "model")), ("model",),
                          ("data",)),
    "a2a_mixtral": ("mixtral-8x7b", "ep_a2a", ((2,), ("model",)),
                    ("model",), ()),
    "a2a_deepseek": ("deepseek-v3-671b", "ep_a2a", ((2,), ("model",)),
                     ("model",), ()),
}
UNIT_EP = {"psum_unit": ("mixtral-8x7b", "ep_psum", ((1,), ("model",)),
                         ("model",), ()),
           "a2a_unit": ("mixtral-8x7b", "ep_a2a", ((1,), ("model",)),
                        ("model",), ())}


def _ep_job(arch, variant, mesh, e_axes, f_axes):
    cfg = _cfg(arch)
    x = np.random.default_rng(1).normal(0, 0.5, (4, 8, cfg.d_model)
                                        ).astype(np.float32)
    return dict(arch=arch, variant=variant, mesh=mesh, expert_axes=e_axes,
                ffn_axes=f_axes, cfg=dict(capacity_factor=8.0),
                p=_moe_layer(cfg), x=torch.from_numpy(x))


def _ep_ref(job, world):
    """moe_dense over the whole batch; aux as the body defines it."""
    cfg = _cfg(job["arch"])
    p = jax.tree.map(jnp.asarray, job["p"])
    x = job["x"].numpy()
    y, aux = j_moe.moe_dense(cfg, p, jnp.asarray(x.reshape(-1, x.shape[-1])))
    if job["variant"] == "ep_a2a":
        s = x.shape[1] // world
        aux = np.mean([float(j_moe.route(cfg, p["router"], jnp.asarray(
            x[:, r * s:(r + 1) * s].reshape(-1, x.shape[-1])))[2])
            for r in range(world)])
    return np.asarray(y).reshape(x.shape), float(aux)


def _compress_job(world):
    rng = np.random.default_rng(2)
    g = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(0, 1, s).astype(np.float32))
    return dict(g=[g(32) for _ in range(world)],
                ef=[[g(16) for _ in range(20)] for _ in range(world)],
                tree=[{"a": g(8), "b": {"c": g(4)}} for _ in range(world)])


# ------------------------------------------------------ the serve and train

def _serve_inputs():
    cfg = _cfg("mixtral-8x7b", capacity_factor=8.0)
    params = init_params(cfg, jax.random.key(0))
    prompt = np.random.default_rng(3).integers(
        2, cfg.vocab_size, (SERVE_B, SERVE_S)).astype(np.int32)
    return cfg, params, prompt


def _serve_ref(cfg, params, prompt, policy):
    cache = j_kvcache.init_cache(cfg, SERVE_B, SERVE_S + SERVE_STEPS,
                                 dtype=jnp.float32)
    out = jax.jit(lambda p, t, c: j_forward(cfg, p, t, cache=c,
                                            mode="prefill"))(
        params, jnp.asarray(prompt), cache)
    step = jax.jit(j_serve_step(cfg, policy))
    cache, tok, logits, toks = out["cache"], jnp.asarray(prompt[:, -1:]), \
        [], []
    for _ in range(SERVE_STEPS):
        nxt, lg, cache = step(params, cache, tok)
        logits.append(np.asarray(lg))
        toks.append(np.asarray(nxt))
        tok = nxt[:, None]
    return np.stack(logits), np.stack(toks)


def _train_ref():
    """The reference's grads and train step on a drop-free mixtral smoke
    (``test_torch_train.jax_step_outputs`` with capacity factor 8.0)."""
    from repro.training import optimizer as jopt
    from repro.training import train_step as jstep
    from repro_torch.training import optimizer as t_opt
    jc = _cfg("mixtral-8x7b", capacity_factor=8.0)
    params = init_params(jc, jax.random.key(0))
    batch = _batch(jc)
    opt = jopt.OptConfig(warmup_steps=2)
    step = jstep.make_train_step(jc, opt)
    loss_fn = jstep.make_loss_fn(jc, None)

    def both(p, s, b):
        (_, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, b)
        return (grads,) + step(p, s, b)

    grads, new_p, new_s, metrics = jax.jit(both)(
        params, jopt.init_opt_state(params, opt),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tc = dataclasses.replace(t_get_config("mixtral-8x7b").smoke(),
                             dtype="float32", capacity_factor=8.0)
    return dict(tc=tc, params=_np(params), batch=batch,
                opt=t_opt.OptConfig(warmup_steps=2), grads=_np(grads),
                new_params=_np(new_p), new_state=_np(new_s),
                metrics={k: float(v) for k, v in metrics.items()})


# ---------------------------------------------------------------- the runs

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp, name, world, job):
    torch.save(job, tmp / f"{name}.job")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world),
         str(tmp / f"{name}.init"), str(tmp / f"{name}.job"),
         str(tmp / f"{name}.{r}.out")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups' jobs, run at once, with launch.train beside them; the
    references are computed while the workers run."""
    tmp = tmp_path_factory.mktemp("dist")
    attn = _attn_inputs()
    ckpt_cfg = _cfg("mixtral-8x7b")
    ckpt_params = _np(init_params(ckpt_cfg, jax.random.key(5)))
    opt_state = {"mu": ckpt_params, "nu": jax.tree.map(np.abs, ckpt_params),
                 "step": np.asarray(3, np.int32)}
    CheckpointManager(str(tmp / "ckpt")).save(
        7, {"params": _t(ckpt_params), "opt_state": _t(opt_state)},
        extra={"note": "whole"})
    scfg, sparams, prompt = _serve_inputs()
    train = _train_ref()
    two = {"lse": {k: v for k, v in _half_partials(attn).items()},
           "seq_attn": {k: (torch.from_numpy(np.asarray(v))
                            if isinstance(v, np.ndarray) else v)
                        for k, v in attn.items()},
           **{f"ep:{n}": _ep_job(*c) for n, c in EP_CASES.items()},
           "compress": _compress_job(2),
           "elastic": dict(arch="mixtral-8x7b", shape="train_4k",
                           dir=str(tmp / "ckpt"))}
    one = {**{f"ep:{n}": _ep_job(*c) for n, c in UNIT_EP.items()},
           "compress": _compress_job(1),
           "serve": dict(arch="mixtral-8x7b", cfg=dict(capacity_factor=8.0),
                         params=_np(sparams), prompt=torch.from_numpy(prompt),
                         steps=SERVE_STEPS,
                         meshes=[((1,), ("model",)),
                                 ((1, 1), ("data", "model"))]),
           "train": dict(arch="mixtral-8x7b", cfg=dict(capacity_factor=8.0),
                         params=train["params"],
                         batch={k: torch.from_numpy(np.array(v))
                                for k, v in train["batch"].items()})}
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), RANK="0",
               WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    launcher = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "olmo-1b", "--smoke", "--steps", "1", "--batch-size", "2",
         "--seq-len", "16", "--device", "cpu"], env=env, cwd=str(tmp),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = {"two": _launch(tmp, "two", 2, two),
             "one": _launch(tmp, "one", 1, one)}
    refs = {"attn": {s: _attn_ref(attn, s) for s in attn["softcaps"]},
            "ep": {n: _ep_ref(two[f"ep:{n}"], 2) for n in EP_CASES},
            "unit_ep": {n: _ep_ref(one[f"ep:{n}"], 1) for n in UNIT_EP},
            "serve_none": _serve_ref(scfg, sparams, prompt, None),
            "serve_model": _serve_ref(scfg, sparams, prompt, JSH.make_plan(
                scfg, dataclasses.replace(
                    j_get_shape("decode_32k"), global_batch=SERVE_B,
                    seq_len=SERVE_S + SERVE_STEPS),
                jax.make_mesh((1,), ("model",))).policy),
            "train": train, "ckpt": ckpt_params, "opt_state": opt_state,
            "ckpt_cfg": ckpt_cfg}
    out = {}
    for name, ps in procs.items():
        logs = [p.communicate(timeout=600)[0] for p in ps]
        assert all(p.returncode == 0 for p in ps), "\n".join(logs)[-4000:]
        out[name] = [torch.load(tmp / f"{name}.{r}.out", weights_only=False)
                     for r in range(len(ps))]
    so, se = launcher.communicate(timeout=600)
    assert launcher.returncode == 0, se[-4000:]
    out["launcher"] = json.loads(so[so.index("{"):])
    return out, refs, two, one


# ---------------------------------------------------------------- 2 ranks

def test_lse_combine_two_ranks(runs):
    out, refs, _, _ = runs
    for r in range(2):
        np.testing.assert_allclose(out["two"][r]["lse"]["out"].numpy(),
                                   refs["attn"][0.0], rtol=ATTN_TOL,
                                   atol=ATTN_TOL)


@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_seq_sharded_attn_two_ranks(runs, softcap):
    """Rows 0 and 2 hold no valid key in one half: that rank's partials
    are (0, m = 0, 0) and its m enters the global max, as in the
    reference."""
    out, refs, _, _ = runs
    for r in range(2):
        got = out["two"][r]["seq_attn"][f"softcap{softcap:g}"].numpy()
        np.testing.assert_allclose(got, refs["attn"][softcap],
                                   rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_bodies_match_dense_two_ranks(runs, name):
    out, refs, _, _ = runs
    y, aux = refs["ep"][name]
    for r in range(2):
        got = out["two"][r][f"ep:{name}"]
        np.testing.assert_allclose(got["out"].numpy(), y, rtol=MOE_TOL,
                                   atol=MOE_TOL)
        assert abs(float(got["aux"]) - aux) <= AUX_TOL * abs(aux)


@pytest.mark.parametrize("method", ["int8", "bf16", "none"])
def test_compressed_psum_two_ranks(runs, method):
    """The sum and both ranks' residuals add up to the exact sum (int8: the
    int32 sum is exact; bf16: up to the rounding of the bf16 sum itself,
    as in the reference's psum); the compressed sum is within one
    quantization step a rank of it."""
    out, _, two, _ = runs
    g = sum(x.numpy() for x in two["compress"]["g"])
    got = [o["compress"][method] for o in out["two"]]
    s, errs = got[0]["out"].numpy(), [o["err"].numpy() for o in got]
    np.testing.assert_array_equal(s, got[1]["out"].numpy())
    tol = 2.0 ** -8 * np.abs(g).max() if method == "bf16" else 1e-5
    np.testing.assert_allclose(s + sum(errs), g, rtol=1e-5, atol=tol)
    if method == "none":
        np.testing.assert_allclose(s, g, rtol=1e-6, atol=1e-6)
        assert not any(e.any() for e in errs)
    else:
        step = (2 * max(np.abs(x.numpy()).max()
                        for x in two["compress"]["g"]) / 127
                if method == "int8" else np.abs(g).max() * 2 ** -7)
        assert np.abs(s - g).max() <= step + 1e-6


def test_error_feedback_two_ranks(runs):
    """Telescoping: the compressed sums over 20 steps plus the final
    residuals equal the true running sum."""
    out, _, two, _ = runs
    true = sum(g.numpy() for rank in two["compress"]["ef"] for g in rank)
    got = out["two"][0]["compress"]["ef"]["sum"].numpy()
    errs = sum(o["compress"]["ef"]["err"].numpy() for o in out["two"])
    np.testing.assert_allclose(got + errs, true, rtol=1e-4, atol=1e-4)


def test_tree_compressed_psum_two_ranks(runs):
    out, _, two, _ = runs
    for path in (("a",), ("b", "c")):
        pick = lambda t: t[path[0]] if len(path) == 1 else \
            t[path[0]][path[1]]  # noqa: E731
        g = sum(pick(t).numpy() for t in two["compress"]["tree"])
        tot = pick(out["two"][0]["compress"]["tree"]["out"]).numpy()
        errs = sum(pick(o["compress"]["tree"]["err"]).numpy()
                   for o in out["two"])
        # bf16: up to the rounding of the bf16 sum itself
        np.testing.assert_allclose(tot + errs, g, rtol=1e-5,
                                   atol=2.0 ** -8 * np.abs(g).max())


def test_restore_elastic_two_ranks(runs):
    """Each rank's leaves are its blocks under the reference's plan for
    the (1, 2) mesh; entries without a spec come back whole."""
    out, refs, _, _ = runs

    class FakeMesh:
        shape = {"data": 1, "model": 2}
        axis_names = ("data", "model")

    jplan = JSH.make_plan(refs["ckpt_cfg"], j_get_shape("train_4k").smoke(),
                          FakeMesh())
    specs = jplan.param_specs
    sharded = 0
    for r, o in enumerate(out["two"]):
        got = o["elastic"]
        assert got["step"] == 7 and got["extra"] == {"note": "whole"}
        assert got["variant"] == jplan.moe_variant
        coords = {"data": 0, "model": r}

        def block(x, spec):
            for dim, axes in enumerate(tuple(spec)):
                if axes is None:
                    continue
                axes = (axes,) if isinstance(axes, str) else tuple(axes)
                n, idx = 1, 0
                for a in axes:
                    n *= FakeMesh.shape[a]
                    idx = idx * FakeMesh.shape[a] + coords[a]
                x = np.split(x, n, axis=dim)[idx]
            return x

        for tree, want in ((got["tree"]["params"], refs["ckpt"]),
                           (got["tree"]["opt_state"]["mu"], refs["ckpt"])):
            for path, spec in jax.tree_util.tree_leaves_with_path(
                    specs, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec)):
                keys = [p.key for p in path]
                g, w = tree, want
                for k in keys:
                    g, w = g[k], w[k]
                b = block(w, spec)
                sharded += b.shape != w.shape
                np.testing.assert_array_equal(g.numpy(), b)
        assert int(got["tree"]["opt_state"]["step"]) == 3
    assert sharded > 0


# ----------------------------------------------------------------- 1 rank

@pytest.mark.parametrize("mesh", ["1:ep_psum", "1x1:grouped_pjit"])
def test_serve_step_under_plan_matches_jax(runs, mesh):
    out, refs, _, _ = runs
    got = out["one"][0]["serve"][mesh]
    want = [refs["serve_none"]]
    if mesh == "1:ep_psum":
        want.append(refs["serve_model"])
    for logits, toks in want:
        np.testing.assert_allclose(got["logits"].numpy(), logits,
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_array_equal(got["tokens"].numpy(), toks)


def test_serve_step_without_plan_matches_jax(runs):
    """The plain greedy step (no policy) in this process."""
    from repro_torch.models import kvcache
    from repro_torch.models.model import forward
    from repro_torch.serving.steps import make_serve_step
    _, refs, _, one = runs
    job = one["serve"]
    cfg = dataclasses.replace(t_get_config("mixtral-8x7b").smoke(),
                              dtype="float32", capacity_factor=8.0)
    params = params_from_numpy(job["params"], "cpu")
    prompt = job["prompt"]
    cache = kvcache.init_cache(cfg, SERVE_B, SERVE_S + SERVE_STEPS,
                               device="cpu")
    step = make_serve_step(cfg)
    with torch.no_grad():
        forward(cfg, params, prompt, cache=cache, mode="prefill")
        tok, logits, toks = prompt[:, -1:], [], []
        for _ in range(SERVE_STEPS):
            nxt, lg, cache = step(params, cache, tok)
            assert nxt.dtype == torch.int32 and lg.dtype == torch.float32
            logits.append(lg.numpy())
            toks.append(nxt.numpy())
            tok = nxt[:, None].long()
    want_logits, want_toks = refs["serve_none"]
    np.testing.assert_allclose(np.stack(logits), want_logits,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_array_equal(np.stack(toks), want_toks)


@pytest.mark.parametrize("remat", [1, 0])
def test_train_step_under_plan_matches_jax(runs, remat):
    out, refs, _, _ = runs
    got = out["one"][0]["train"][f"remat{remat}"]
    assert got["variant"] == "ep_a2a"
    assert_step_matches(refs["train"], got)


def test_train_step_remat_equals_without(runs):
    """Recomputing the blocks in the backward changes no number."""
    got = runs[0]["one"][0]["train"]
    assert got["remat1"]["metrics"] == got["remat0"]["metrics"]
    for a, b in zip(jax.tree.leaves(got["remat1"]["grads"]),
                    jax.tree.leaves(got["remat0"]["grads"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(UNIT_EP))
def test_ep_bodies_match_dense_on_unit_mesh(runs, name):
    """``test_moe.py``'s unit-mesh test: ep_psum also against the
    reference's own shard fn on ``jax.make_mesh((1,), ("model",))``."""
    out, refs, _, one = runs
    got = out["one"][0][f"ep:{name}"]
    y, aux = refs["unit_ep"][name]
    np.testing.assert_allclose(got["out"].numpy(), y, rtol=MOE_TOL,
                               atol=MOE_TOL)
    assert abs(float(got["aux"]) - aux) <= AUX_TOL * abs(aux)
    if name == "psum_unit":
        from repro.distributed.collectives import make_moe_shard_fn
        job = one[f"ep:{name}"]
        cfg = _cfg("mixtral-8x7b")
        fn = make_moe_shard_fn(jax.make_mesh((1,), ("model",)), cfg,
                               variant="ep_psum", dp_axes=(),
                               expert_axes=("model",), capacity_factor=8.0)
        yj, auxj = fn(cfg, jax.tree.map(jnp.asarray, job["p"]),
                      jnp.asarray(job["x"].numpy()))
        np.testing.assert_allclose(got["out"].numpy(), np.asarray(yj),
                                   rtol=MOE_TOL, atol=MOE_TOL)
        assert abs(float(got["aux"]) - float(auxj)) <= AUX_TOL * abs(aux)


def test_compressed_psum_single_rank_identity(runs):
    """``test_compression.py``: at one rank the sum plus the residual is
    the gradient, int8 and bf16."""
    out, _, _, one = runs
    g = one["compress"]["g"][0].numpy()
    for method in ("int8", "bf16"):
        got = out["one"][0]["compress"][method]
        np.testing.assert_allclose(got["out"].numpy() + got["err"].numpy(),
                                   g, rtol=1e-5, atol=1e-5)


def test_error_feedback_converges_single_rank(runs):
    """``test_compression.py``: over 20 steps the estimates track the true
    running sum within the final residual."""
    out, _, _, one = runs
    true = sum(g.numpy() for g in one["compress"]["ef"][0])
    got = out["one"][0]["compress"]["ef"]
    resid = np.abs(true - got["sum"].numpy())
    assert resid.max() <= np.abs(got["err"].numpy()).max() + 1e-4


def test_tree_compression_threads_state_single_rank(runs):
    out, _, _, one = runs
    got = out["one"][0]["compress"]["tree"]
    g = one["compress"]["tree"][0]
    assert set(got["out"]) == set(g) and set(got["out"]["b"]) == {"c"}
    np.testing.assert_allclose(got["out"]["a"].numpy()
                               + got["err"]["a"].numpy(), g["a"].numpy(),
                               rtol=1e-5, atol=1e-5)


@given(st.lists(st.floats(-100, 100, allow_nan=False), min_size=1,
                max_size=64))
@settings(max_examples=50, deadline=None)
def test_int8_quantization_error_bound(xs):
    x = torch.tensor(xs, dtype=torch.float32)
    q, scale = quantize_int8(x)
    err = float((dequantize_int8(q, scale) - x).abs().max())
    assert err <= float(scale) * 0.5 + 1e-6


def test_launch_train_joins_the_launchers_group(runs):
    got = runs[0]["launcher"]
    assert got["process_group"] == {"backend": "gloo", "rank": 0,
                                    "world_size": 1}
    assert np.isfinite(got["final"]["loss"])
