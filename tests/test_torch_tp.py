"""Whole steps under a sharding plan over 2 and 4 ranks (tensor
parallelism of the dense layers, FSDP, the grouped MoE's local body)
against the JAX package's single-device steps, in gloo groups on the CPU.

``tests/torch_dist_worker.py`` runs the cases in one group of 2 ranks
(mesh ("model",)) and one of 4 (meshes ("data", "model") 2 x 2 and
("model",) 4), each launched once for the module; the weights come from
the reference's ``init_params`` (f32, ``.smoke()``), the references from
the JAX package in this process while the groups run.  Each rank holds its
slices of the weights (``shard_tree`` by the plan's specs), its rows of the
batch over the plan's dp axes and its slots of the decode ring.

Configs: mixtral (capacity 8.0, so no bucket drops), qwen2.5-3b (QKV bias,
tied embeddings, 2 KV heads: at model 4 its ``wk`` / ``wv`` split finer
than a head, gathered whole at use) and mixtral with 6 experts at model 4
(no expert split: every expert on its slice of ``effn``).  The plans run
ep_psum / ep_a2a at ("model",) 2, the grouped MoE with experts over
("data", "model") in decode and ep_a2a with FSDP's ``embed`` over 'data'
in training at 2 x 2.

  * decode: a prefill of 12 tokens and 8 greedy ``make_serve_step`` steps,
    the ranks' rows put back in order: logits within 1e-4 of the
    reference's, tokens equal;
  * train: loss within 1e-5 relative and grad norm within 1e-4 relative of
    the reference's ``make_train_step``; each rank's block of every
    gradient within 1e-5 of the leaf's max-abs of the port's one-rank
    step (policy None, in this process); mixtral's ("model",) 2 plan also
    through ``make_microbatched_train_step`` against the reference's;
  * the conjugate pairs: a replicated activation's gradient at 2 ranks
    equals the one-rank gradient (not twice it) through the dense FFN
    split by ``ffn`` and through the ``ep_a2a`` body, and a backward
    through ``ep_psum`` over 2 ranks raises.

In this process, with no group: what a step over more than one rank does
not run raises ``NotImplementedError`` (Mamba, MLA, ``decode_2d``, paged
and int8 KV, whisper's encoder, paligemma's prefix, shared experts,
chunked prefill), and so do the sequence-sharded attention's paged, int8
and MLA forms at one rank.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import kvcache as j_kvcache  # noqa: E402
from repro.models.inputs import concrete_inputs  # noqa: E402
from repro.models.model import forward as j_forward  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.serving.steps import make_serve_step as j_serve_step  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import get_shape as t_get_shape  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from test_torch_distributed import _cfg, _launch, _np  # noqa: E402

LOGIT_TOL, LOSS_TOL, NORM_TOL, GRAD_TOL = 1e-4, 1e-5, 1e-4, 1e-5
PAIR_TOL = 1e-5
B, S, STEPS = 4, 12, 8
CONFIGS = {"mixtral": ("mixtral-8x7b", {"capacity_factor": 8.0}),
           "qwen": ("qwen2.5-3b", {}),
           "mixtral_e6": ("mixtral-8x7b", {"capacity_factor": 8.0,
                                           "num_experts": 6})}
M2, DM, M4 = ((2,), ("model",)), ((2, 2), ("data", "model")), \
    ((4,), ("model",))
GROUPS = {2: [("mixtral", M2), ("qwen", M2)],
          4: [("mixtral", DM), ("qwen", DM), ("qwen", M4),
              ("mixtral_e6", M4)]}
CASES = [(w, c, m) for w, cs in GROUPS.items() for c, m in cs]
# the micro-batched step's case: its micro-batches are the reference's
# only where the batch is whole on every rank (no dp axis)
MICRO, NUM_MICRO = ("mixtral", M2), 2
VARIANTS = {("mixtral", M2): ("ep_psum", "ep_a2a"),
            ("mixtral", DM): ("grouped_pjit", "ep_a2a"),
            ("mixtral_e6", M4): ("grouped_pjit", "grouped_pjit")}


def _label(cfg_name, mesh):
    return f"{cfg_name}@{'x'.join(map(str, mesh[0]))}"


def _inputs(name):
    arch, kw = CONFIGS[name]
    jc = _cfg(arch, **kw)
    params = init_params(jc, jax.random.key(0))
    prompt = np.random.default_rng(3).integers(
        2, jc.vocab_size, (B, S)).astype(np.int32)
    batch = {k: np.array(v) for k, v in concrete_inputs(
        jc, t_get_shape("train_4k").smoke(), seed=0).items()}
    return jc, params, prompt, batch


def _serve_ref(jc, params, prompt):
    cache = j_kvcache.init_cache(jc, B, S + STEPS, dtype=jnp.float32)
    out = jax.jit(lambda p, t, c: j_forward(jc, p, t, cache=c,
                                            mode="prefill"))(
        params, jnp.asarray(prompt), cache)
    step = jax.jit(j_serve_step(jc, None))
    cache, tok, logits, toks = out["cache"], jnp.asarray(prompt[:, -1:]), \
        [], []
    for _ in range(STEPS):
        nxt, lg, cache = step(params, cache, tok)
        logits.append(np.asarray(lg))
        toks.append(np.asarray(nxt))
        tok = nxt[:, None]
    return np.stack(logits), np.stack(toks)


def _train_ref(jc, params, batch, num_micro=1):
    """The reference's make_train_step (or micro-batched step) metrics."""
    from repro.training import optimizer as jopt
    from repro.training import train_step as jstep
    opt = jopt.OptConfig(warmup_steps=2)
    step = (jstep.make_microbatched_train_step(jc, opt, None, num_micro)
            if num_micro > 1 else jstep.make_train_step(jc, opt))
    _, _, metrics = jax.jit(step)(
        params, jopt.init_opt_state(params, opt),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: float(v) for k, v in metrics.items()}


def _port_grads(name, np_params, batch):
    """The port's one-rank gradients (no plan), in this process."""
    from repro_torch.training import train_step as t_step
    arch, kw = CONFIGS[name]
    tc = dataclasses.replace(t_get_config(arch).smoke(), dtype="float32",
                             **kw)
    params = t_step.requires_grad_(params_from_numpy(np_params, "cpu"))
    _, _, grads = t_step.value_and_grad(
        t_step.make_loss_fn(tc, None), params,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return tc, grads


def _pairs_ref(job):
    """The one-rank forward and gradients of the pairs case."""
    from repro_torch.models import moe
    from repro_torch.models.model import dense_ffn
    arch, kw = CONFIGS["mixtral"]
    tc = dataclasses.replace(t_get_config(arch).smoke(), dtype="float32",
                             **kw)
    out = {}
    x = job["x"].clone().requires_grad_(True)
    y = dense_ffn(tc, job["ffn"], x)
    y.square().sum().backward()
    out["ffn"] = {"y": y.detach(), "dx": x.grad}
    p = params_from_numpy(job["params"], "cpu")["blocks"]["p0"]["moe"]
    p = {k: v[0].clone().requires_grad_(True) for k, v in p.items()}
    x = job["x"].clone().requires_grad_(True)
    y, aux = moe.moe_dense(tc, p, x.reshape(-1, x.shape[-1]))
    (y.square().sum() + aux).backward()
    out["a2a"] = {"y": y.detach().reshape(x.shape), "aux": aux.detach(),
                  "dx": x.grad, "grads": {k: v.grad for k, v in p.items()}}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups launched at once; the references meanwhile."""
    tmp = tmp_path_factory.mktemp("tp")
    inputs = {n: _inputs(n) for n in CONFIGS}
    jobs = {w: {} for w in GROUPS}
    for w, name, mesh in CASES:
        jc, params, prompt, batch = inputs[name]
        arch, kw = CONFIGS[name]
        base = dict(arch=arch, cfg=kw, mesh=mesh, params=_np(params))
        jobs[w][f"tp_serve:{_label(name, mesh)}"] = dict(
            base, prompt=torch.from_numpy(prompt), steps=STEPS)
        jobs[w][f"tp_train:{_label(name, mesh)}"] = dict(
            base, batch={k: torch.from_numpy(v) for k, v in batch.items()},
            num_micro=NUM_MICRO if (name, mesh) == MICRO else 0)
    rng = np.random.default_rng(4)
    d, f = 64, 128
    pairs = dict(arch="mixtral-8x7b", cfg=CONFIGS["mixtral"][1],
                 params=_np(inputs["mixtral"][1]),
                 x=torch.from_numpy(rng.normal(0, 0.5, (2, 8, d)).astype(
                     np.float32)),
                 ffn={"wi": torch.from_numpy(rng.normal(
                     0, d ** -0.5, (d, 2, f)).astype(np.float32)),
                     "wo": torch.from_numpy(rng.normal(
                         0, f ** -0.5, (f, d)).astype(np.float32))})
    jobs[2]["tp_pairs"] = pairs
    procs = {w: _launch(tmp, f"tp{w}", w, job) for w, job in jobs.items()}
    refs = {"serve": {n: _serve_ref(*inputs[n][:3]) for n in CONFIGS},
            "train": {n: _train_ref(inputs[n][0], inputs[n][1],
                                    inputs[n][3]) for n in CONFIGS},
            "micro": _train_ref(*(inputs[MICRO[0]][i] for i in (0, 1, 3)),
                                num_micro=NUM_MICRO),
            "grads": {n: _port_grads(n, _np(inputs[n][1]), inputs[n][3])
                      for n in CONFIGS},
            "pairs": _pairs_ref(pairs)}
    out = {}
    for w, ps in procs.items():
        logs = [p.communicate(timeout=600)[0] for p in ps]
        assert all(p.returncode == 0 for p in ps), "\n".join(logs)[-4000:]
        out[w] = [torch.load(tmp / f"tp{w}.{r}.out", weights_only=False)
                  for r in range(w)]
    return out, refs


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("world,name,mesh", CASES,
                         ids=[f"{w}-{_label(c, m)}" for w, c, m in CASES])
def test_decode_under_plan_matches_jax(runs, world, name, mesh):
    """Every rank's rows of every step's logits (whole over the
    vocabulary) and tokens, against the reference's single-device step."""
    out, refs = runs
    want_logits, want_toks = refs["serve"][name]
    got = [o[f"tp_serve:{_label(name, mesh)}"] for o in out[world]]
    if (name, mesh) in VARIANTS:
        assert got[0]["variant"] == VARIANTS[name, mesh][0]
    n_dp = 1 + max(g["dp_index"] for g in got)
    rows = B // n_dp
    for g in got:
        sl = slice(g["dp_index"] * rows, (g["dp_index"] + 1) * rows)
        np.testing.assert_allclose(g["logits"].numpy(), want_logits[:, sl],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_array_equal(g["tokens"].numpy(), want_toks[:, sl])


@pytest.mark.parametrize("world,name,mesh", CASES,
                         ids=[f"{w}-{_label(c, m)}" for w, c, m in CASES])
def test_train_step_under_plan_matches_jax(runs, world, name, mesh):
    """Loss and grad norm against the reference's step; each rank's block
    of every gradient against the port's one-rank gradients."""
    out, refs = runs
    want = refs["train"][name]
    tc, grads = refs["grads"][name]
    got = [o[f"tp_train:{_label(name, mesh)}"] for o in out[world]]
    if (name, mesh) in VARIANTS:
        assert got[0]["variant"] == VARIANTS[name, mesh][1]
    plan = SH.make_plan(tc, t_get_shape("train_4k").smoke(), Mesh(*mesh))
    specs = dict(_leaves(plan.param_specs))
    for r, g in enumerate(got):
        for k in ("loss", "lm_loss", "aux_loss"):
            assert abs(g["metrics"][k] - want[k]) <= LOSS_TOL * abs(want[k]), \
                (k, g["metrics"][k], want[k])
        assert abs(g["metrics"]["grad_norm"] - want["grad_norm"]) <= \
            NORM_TOL * want["grad_norm"]
        mine = dict(_leaves(g["grads"]))
        rank_mesh = Mesh(*mesh, rank=r)
        for path, full in _leaves(grads):
            block = SH.local_slice(full, specs[path], rank_mesh)
            err = float((mine[path] - block).abs().max())
            scale = float(full.abs().max())
            assert err <= GRAD_TOL * scale, (r, path, err, scale)


def test_microbatched_train_step_under_plan_matches_jax(runs):
    """``make_microbatched_train_step`` (2 micro-batches) under mixtral's
    ("model",) 2 train plan: loss within 1e-5 and grad norm within 1e-4,
    relative, of the reference's micro-batched step."""
    out, refs = runs
    want = refs["micro"]
    for o in out[2]:
        got = o[f"tp_train:{_label(*MICRO)}"]["micro"]
        assert abs(got["loss"] - want["loss"]) <= LOSS_TOL * want["loss"]
        assert abs(got["grad_norm"] - want["grad_norm"]) <= \
            NORM_TOL * want["grad_norm"]


def test_replicated_activation_gradient_is_not_scaled(runs):
    """At 2 ranks x enters both split regions replicated, and each rank's
    dx equals the one-rank dx: the split FFN (copy_to / reduce_from) and
    the ep_a2a body (scatter_to / gather_from, the router's copy_to), with
    the global batch's aux; the a2a body's expert gradients are each
    rank's experts' blocks."""
    out, refs = runs
    want = refs["pairs"]
    for r, o in enumerate(out[2]):
        got = o["tp_pairs"]
        for part in ("ffn", "a2a"):
            for k in ("y", "dx"):
                np.testing.assert_allclose(got[part][k].numpy(),
                                           want[part][k].numpy(),
                                           rtol=PAIR_TOL, atol=PAIR_TOL)
        assert abs(float(got["a2a"]["aux"]) - float(want["a2a"]["aux"])) \
            <= PAIR_TOL * float(want["a2a"]["aux"])
        for k, g in got["a2a"]["grads"].items():
            w = want["a2a"]["grads"][k]
            if k != "router":
                w = w.chunk(2)[r]
            np.testing.assert_allclose(g.numpy(), w.numpy(),
                                       rtol=PAIR_TOL,
                                       atol=PAIR_TOL * float(w.abs().max()))
        assert "ep_psum" in got["psum_raised"]


# ------------------------------------------------- raises, in this process

def _smoke(arch, **kw):
    return dataclasses.replace(t_get_config(arch).smoke(), dtype="float32",
                               **kw)


REFUSED = {
    # name: (arch, config changes, shape, mesh, make_plan kw, forward mode)
    "mamba2": ("mamba2-1.3b", {}, "train_4k", M2, {}, "train"),
    "jamba": ("jamba-1.5-large-398b", {}, "decode_32k", M2, {}, "decode"),
    "mla_train": ("deepseek-v3-671b", {}, "train_4k", M2, {}, "train"),
    "mla_decode": ("deepseek-v3-671b", {}, "decode_32k", M2, {}, "decode"),
    "whisper": ("whisper-small", {}, "train_4k", M2, {}, "train"),
    "paligemma_prefix": ("paligemma-3b", {}, "train_4k", M2, {}, "train"),
    "decode_2d": ("mixtral-8x7b", {}, "decode_32k", DM,
                  {"decode_2d": True}, "decode"),
    "shared_experts": ("mixtral-8x7b", {"num_shared_experts": 1},
                       "train_4k", M2, {}, "train"),
    "chunk_prefill": ("qwen2.5-3b", {}, "decode_32k", M2, {},
                      "chunk_prefill")}
MATCH = {"mamba2": "Mamba-2", "jamba": "Mamba-2", "mla_train": "MLA",
         "mla_decode": "MLA", "whisper": "whisper",
         "paligemma_prefix": "paligemma", "decode_2d": "decode_2d",
         "shared_experts": "shared experts",
         "chunk_prefill": "chunked prefill"}


@pytest.mark.parametrize("name", list(REFUSED))
def test_step_over_two_ranks_raises_for_what_is_not_ported(name):
    """Before any collective: the plan's mesh holds names and sizes
    only, so a step that got past the check would fail on its first
    process group."""
    from repro_torch.models import kvcache
    from repro_torch.models.model import forward
    arch, changes, shape, mesh, kw, mode = REFUSED[name]
    cfg = _smoke(arch, **changes)
    plan = SH.make_plan(cfg, t_get_shape(shape).smoke(), Mesh(*mesh), **kw)
    tokens = torch.ones((2, 1 if mode == "decode" else 4), dtype=torch.long)
    extra = ({"patches": torch.zeros((2, cfg.vision_tokens, cfg.d_model))}
             if name == "paligemma_prefix" else {})
    cache = (kvcache.init_cache(cfg, 2, 8, device="cpu")
             if mode != "train" else None)
    with pytest.raises(NotImplementedError, match=MATCH[name]):
        forward(cfg, {}, tokens, cache=cache, mode=mode,
                policy=plan.policy, **extra)


def _layer_cache(cfg, paged):
    from repro_torch.models import kvcache
    cache = kvcache.init_cache(cfg, 2, 8, device="cpu")["p0"]
    cache = {k: v[0] for k, v in cache.items()}
    if paged:
        cache["page_table"] = torch.zeros((2, 1), dtype=torch.int32)
    return cache


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("kind", ["paged", "int8"])
def test_sharded_decode_raises_for_paged_and_int8_kv(world, kind):
    """A block-paged or int8 ring under the sequence-sharded attention of a
    mesh of one rank (``attn_fn``) and under a plan over two (``shard``)."""
    from repro_torch.models import attention
    from repro_torch.models.params import init_params as t_init
    cfg = _smoke("qwen2.5-3b", **({"kv_dtype": "int8"} if kind == "int8"
                                  else {}))
    plan = SH.make_plan(cfg, t_get_shape("decode_32k").smoke(),
                        Mesh((world,), ("model",)))
    p = t_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    p = {k: v[0] for k, v in p["blocks"]["p0"]["attn"].items()}
    x = torch.zeros((2, 1, cfg.d_model))
    pos = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match=kind.replace(
            "paged", "block-paged")):
        attention.gqa_forward(cfg, cfg.period[0], p, x, pos[:, None],
                              cache=_layer_cache(cfg, kind == "paged"),
                              mode="decode", pos=pos,
                              attn_fn=plan.policy.attn_fn,
                              shard=plan.policy.shard)


def test_mla_decode_under_seq_sharded_attention_raises():
    from repro_torch.models import attention
    cfg = _smoke("deepseek-v3-671b")
    plan = SH.make_plan(cfg, t_get_shape("decode_32k").smoke(),
                        Mesh((1,), ("model",)))
    with pytest.raises(NotImplementedError, match="MLA"):
        attention.mla_forward(cfg, cfg.prologue[0], {}, None, None,
                              cache=None, mode="decode",
                              attn_fn=plan.policy.attn_fn)
