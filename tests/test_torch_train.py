"""The port's training path against the JAX package's, in float32 on the CPU.

  * ``xent`` and ``chunked_lm_loss`` (value and gradient of the hidden
    states) against the reference's, with the VLM prefix mask and a
    ``chunk`` that does not divide S.
  * ``apply_updates`` over 3 steps against the reference's, with the clip
    active and with bfloat16 moments; the in-place update leaves the
    caller's tensors rewritten, not replaced.
  * ``ref.flash_prefill_bwd_ref`` (the plain math of the backward kernel)
    against autograd of ``flash_prefill_ref`` and against ``jax.grad`` of
    the reference's ``chunked_attention``, within 1e-5: causal GQA,
    window, softcap, kv_len, non-causal cross, D 192 / Dv 128.
  * A whole train step against ``make_train_step`` for mixtral (the MoE
    aux loss) and olmo-1b: loss, lm_loss, aux_loss and grad_norm within
    1e-5 relative, every gradient leaf within 1e-4 of its max-abs, the
    updated parameters within 1e-6 of each leaf's max-abs where the
    gradient element is above the gradients' tolerance (below it, Adam's
    first step, about lr * sign(g), is only bounded);
    ``test_torch_train_archs.py`` does deepseek-v3, paligemma-3b and
    whisper-small.
  * ``make_microbatched_train_step(num_micro=2)`` against the full batch
    (as ``test_system.py`` holds the reference) and against the
    reference's microbatched step.
  * A query row without a valid key: the plain backward math gives it the
    kernels' meaning (no dq, no share in dk or dv), which is autograd of
    the plain version with the row's output gradient zeroed.
  * On the card (marker ``cuda``): attention's gradients through the
    ``flash_prefill_bwd`` kernel against autograd of the plain version;
    the backward kernel alone against ``flash_prefill_bwd_ref`` fed the
    forward kernel's o and lse; rows without a valid key.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels import flash_prefill as t_flash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.training import losses as t_losses  # noqa: E402
from repro_torch.training import optimizer as t_opt  # noqa: E402
from repro_torch.training import train_step as t_step  # noqa: E402

LOSS_TOL = 1e-5      # loss, lm_loss, aux_loss, grad_norm: relative
GRAD_TOL = 1e-4      # each gradient leaf: of its max-abs
PARAM_TOL = 1e-6     # updated parameters: of each leaf's max-abs
BWD_TOL = 1e-5       # the plain backward vs autograd / jax.grad


def _jax():
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", False)
    return jax, jnp


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _cfgs(arch):
    from repro.configs import get_config
    return tuple(dataclasses.replace(get(arch).smoke(), dtype="float32")
                 for get in (get_config, t_get_config))


def _batch(jc, seed=0):
    """The reference's train inputs at the smoke shape, as numpy."""
    jax, _ = _jax()
    from repro.configs import get_shape
    from repro.models.inputs import concrete_inputs
    b = concrete_inputs(jc, get_shape("train_4k").smoke(), seed=seed)
    return {k: np.asarray(v) for k, v in b.items()}


def _port_params(np_params):
    return t_step.requires_grad_(params_from_numpy(np_params, "cpu"))


def jax_step_outputs(arch, opt_kw=None, num_micro=1):
    """Weights drawn by the reference's init (f32), the batch, and the
    reference's (grads, new params, new state, metrics) from one jitted
    call of ``make_train_step`` (or the microbatched step), beside its
    ``value_and_grad`` of ``make_loss_fn``, all as numpy."""
    jax, _ = _jax()
    from repro.models.params import init_params
    from repro.training import optimizer as jopt
    from repro.training import train_step as jstep
    jc, tc = _cfgs(arch)
    opt_kw = opt_kw or {}
    params = init_params(jc, jax.random.key(0))
    batch = _batch(jc)
    opt = jopt.OptConfig(warmup_steps=2, **opt_kw)
    if num_micro > 1:
        step = jstep.make_microbatched_train_step(jc, opt, None, num_micro)
    else:
        step = jstep.make_train_step(jc, opt)
    loss_fn = jstep.make_loss_fn(jc, None)

    def both(p, s, b):
        (_, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, b)
        return (grads,) + step(p, s, b)

    grads, new_p, new_s, metrics = jax.jit(both)(
        params, jopt.init_opt_state(params, opt),
        {k: jax.numpy.asarray(v) for k, v in batch.items()})
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(tc=tc, params=to_np(params), batch=batch,
                opt=t_opt.OptConfig(warmup_steps=2, **opt_kw),
                grads=to_np(grads), new_params=to_np(new_p),
                new_state=to_np(new_s),
                metrics={k: float(v) for k, v in metrics.items()})


def port_step_outputs(ref_out, num_micro=1):
    """The port's (grads, params after the step, state, metrics) on the
    reference's weights and batch."""
    tc = ref_out["tc"]
    params = _port_params(ref_out["params"])
    batch = {k: _t(v) for k, v in ref_out["batch"].items()}
    _, _, grads = t_step.value_and_grad(t_step.make_loss_fn(tc, None),
                                        params, batch)
    opt = ref_out["opt"]
    if num_micro > 1:
        step = t_step.make_microbatched_train_step(tc, opt, None, num_micro)
    else:
        step = t_step.make_train_step(tc, opt)
    state = t_opt.init_opt_state(params, opt)
    new_p, new_s, metrics = step(params, state, batch)
    return dict(grads=grads, new_params=new_p, new_state=new_s,
                metrics={k: float(v) for k, v in metrics.items()})


def assert_step_matches(ref_out, got, keys=("loss", "lm_loss", "aux_loss",
                                            "grad_norm")):
    for k in keys:
        want = ref_out["metrics"][k]
        assert abs(got["metrics"][k] - want) <= LOSS_TOL * max(abs(want),
                                                               1e-30), k
    grads = dict(_leaves(got["grads"]))
    for path, want in _leaves(ref_out["grads"]):
        g = grads[path]
        scale = float(np.abs(want).max())
        if g is None:                 # the loss does not reach the leaf
            assert scale == 0.0, path
            continue
        err = float(np.abs(g.detach().numpy() - want).max())
        assert err <= GRAD_TOL * max(scale, 1e-30), (path, err, scale)
    # Adam's first step is about lr * sign(g): where a gradient element is
    # below the gradients' own tolerance (GRAD_TOL of the leaf's max-abs)
    # the two f32 sums may give it other signs, and the step there is only
    # bounded, by 2 lr (1 + weight_decay |p|); everywhere else the updated
    # parameter agrees within PARAM_TOL of the leaf's max-abs
    new = dict(_leaves(got["new_params"]))
    ref_grads = dict(_leaves(ref_out["grads"]))
    lr = ref_out["metrics"]["lr"]
    wd = ref_out["opt"].weight_decay
    for path, want in _leaves(ref_out["new_params"]):
        err = np.abs(new[path].detach().numpy() - want)
        g = np.abs(ref_grads[path])
        firm = g >= GRAD_TOL * float(g.max())
        assert float(err[firm].max(initial=0.0)) <= \
            PARAM_TOL * float(np.abs(want).max()), path
        assert (err[~firm] <= 2 * lr * (1 + wd * np.abs(want[~firm]))
                + 1e-7).all(), path
    assert int(got["new_state"]["step"]) == int(ref_out["new_state"]["step"])


# --------------------------------------------------------------------- losses

def test_xent_matches_reference():
    jax, jnp = _jax()
    from repro.training import losses as jl
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (37, 50)).astype(np.float32)
    tgt = rng.integers(0, 50, 37).astype(np.int32)
    mask = (rng.random(37) < 0.8).astype(np.float32)
    s, n = t_losses.xent(_t(logits), _t(tgt), _t(mask))
    js, jn = jl.xent(jnp.asarray(logits), jnp.asarray(tgt), jnp.asarray(mask))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-6)
    assert float(n) == float(jn)


@pytest.mark.parametrize("arch,chunk", [("olmo-1b", 16), ("olmo-1b", 24),
                                        ("paligemma-3b", 40)])
def test_chunked_lm_loss_matches_reference(arch, chunk):
    """Value and d/d(hidden) against the reference; chunk 24 and 40 do
    not divide S = 64 (padding), paligemma masks its 16-token prefix."""
    jax, jnp = _jax()
    from repro.models.params import init_params
    from repro.training import losses as jl
    jc, tc = _cfgs(arch)
    params = jax.tree.map(np.asarray, init_params(jc, jax.random.key(1)))
    rng = np.random.default_rng(2)
    hidden = rng.normal(0, 1, (2, 64, jc.d_model)).astype(np.float32)
    tgt = rng.integers(0, jc.vocab_size, (2, 64)).astype(np.int32)
    tgt[0, 5] = -1                       # a masked target
    fn = lambda h: jl.chunked_lm_loss(jc, params, h, jnp.asarray(tgt),  # noqa
                                      chunk=chunk)
    want, want_g = jax.value_and_grad(fn)(jnp.asarray(hidden))
    tp = params_from_numpy(params, "cpu")
    h = _t(hidden).requires_grad_(True)
    got = t_losses.chunked_lm_loss(tc, tp, h, _t(tgt), chunk=chunk)
    (got_g,) = torch.autograd.grad(got, h)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               atol=1e-6 * float(np.abs(want_g).max()))
    if jc.vision_tokens:                 # the prefix takes no gradient
        assert not got_g[:, :jc.vision_tokens].any()


# ------------------------------------------------------------------ optimizer

@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(moment_dtype):
    """3 AdamW steps from the warmup's start, the clip active (gradients of
    norm ~30 against grad_clip 1), on a tree with a stacked leaf split
    into slices (SLICE_ELEMS lowered) and a scalar."""
    jax, jnp = _jax()
    from repro.training import optimizer as jopt
    rng = np.random.default_rng(3)
    params = {"a": {"w": rng.normal(0, 1, (3, 4, 5)).astype(np.float32)},
              "b": rng.normal(0, 1, (7,)).astype(np.float32),
              "c": np.float32(0.5)}
    kw = dict(warmup_steps=4, moment_dtype=moment_dtype)
    jo, to = jopt.OptConfig(**kw), t_opt.OptConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_opt_state(jp, jo)
    tp = {"a": {"w": _t(params["a"]["w"])}, "b": _t(params["b"]),
          "c": torch.tensor(params["c"])}
    ts = t_opt.init_opt_state(tp, to)
    w_before = tp["a"]["w"]
    old = t_opt.SLICE_ELEMS
    t_opt.SLICE_ELEMS = 8                # (3,4,5) -> 12 slices of 5
    try:
        for i in range(3):
            g = jax.tree.map(lambda p: np.asarray(  # noqa: B023
                rng.normal(0, 10, np.shape(p)), np.float32), params)
            jp, js, jm = jopt.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                            js, jo)
            tg = {"a": {"w": _t(g["a"]["w"])}, "b": _t(g["b"]),
                  "c": torch.tensor(g["c"])}
            tp, ts, tm = t_opt.apply_updates(tp, tg, ts, to)
            assert jm["grad_norm"] > 1.0     # clipped
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-6)
            np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                       rtol=1e-7)
    finally:
        t_opt.SLICE_ELEMS = old
    assert tp["a"]["w"] is w_before          # rewritten in place
    assert int(ts["step"]) == int(js["step"]) == 3
    for (path, a), (_, b) in zip(_leaves(tp), _leaves(
            jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7,
                                   err_msg=str(path))
    for name in ("mu", "nu"):
        for (path, a), (_, b) in zip(_leaves(ts[name]), _leaves(
                jax.tree.map(np.asarray, js[name]))):
            assert str(a.dtype).endswith(moment_dtype)
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=1e-5 if moment_dtype == "float32"
                                       else 1e-2, atol=1e-7,
                                       err_msg=f"{name} {path}")


# ----------------------------------------------------- attention's backward

BWD_CASES = [
    # (B, S, Skv, H, Hkv, D, Dv, causal, window, softcap, kv_len)
    (2, 40, 40, 4, 2, 16, 16, True, 0, 0.0, None),        # causal GQA
    (2, 40, 40, 4, 1, 16, 16, True, 9, 0.0, None),        # window
    (1, 33, 33, 2, 2, 16, 16, True, 0, 5.0, None),        # softcap
    (2, 40, 40, 4, 2, 16, 16, True, 0, 0.0, (40, 23)),    # kv_len
    (2, 12, 30, 4, 4, 16, 16, False, 0, 0.0, (30, 17)),   # non-causal cross
    (1, 24, 24, 4, 4, 24, 16, True, 0, 0.0, None),        # D != Dv (MLA)
]


def _bwd_inputs(case, seed):
    B, S, Skv, H, Hkv, D, Dv, _, _, cap, kl = case
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 4.0 if cap else 1.0, (B, S, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, Skv, Hkv, Dv)).astype(np.float32)
    do = rng.normal(0, 1, (B, S, H, Dv)).astype(np.float32)
    lens = None if kl is None else np.asarray(kl, np.int32)
    return q, k, v, do, lens


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_prefill_bwd_ref_matches_autograd_and_jax(case):
    """No case has a query row without a valid key (training has none)."""
    jax, jnp = _jax()
    from repro.models.common import chunked_attention
    causal, window, cap = case[7:10]
    q, k, v, do, lens = _bwd_inputs(case, 0)
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    tl = None if lens is None else _t(lens)
    o = ref.flash_prefill_ref(tq, tk, tv, tl, **kw)
    auto = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    plain = ref.flash_prefill_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                      o.detach(), _t(do), tl, **kw)

    def jfn(q, k, v):
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                attn_softcap=cap,
                                kv_len=None if lens is None
                                else jnp.asarray(lens))
        return jnp.sum(out * jnp.asarray(do))

    jgrad = jax.grad(jfn, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for name, p, a, j in zip("qkv", plain, auto, jgrad):
        scale = float(np.abs(np.asarray(j)).max())
        for other in (a, _t(np.asarray(j))):
            err = float((p - other).abs().max())
            assert err <= BWD_TOL * scale, (name, err, scale)


# Query rows 68 and 69 of batch 0 see no valid key: the window of 9 ends
# at key 60, past its kv_len.  The kernels give such a row 0 and lse -inf,
# so it sends nothing back; the plain version (a finite mask) averages
# every key of the row instead, and its autograd sends dv to them all.
EMPTY_ROW_CASE = (2, 70, 70, 4, 2, 16, 16, True, 9, 0.0, (60, 70))


def _rows_with_a_key(case):
    """(B, S) bool: whether the query row sees any valid key."""
    B, S, Skv, _, _, _, _, causal, window, _, kl = case
    lens = np.full(B, Skv) if kl is None else np.asarray(kl)
    i = np.arange(S)[None, :]
    if not causal:
        return np.broadcast_to(lens[:, None] > 0, (B, S))
    first = np.maximum(i - window + 1, 0) if window else np.zeros_like(i)
    return (first < lens[:, None]) & (first <= i)


def test_flash_prefill_bwd_ref_rows_without_a_key():
    """The plain backward math gives a row without a valid key the
    kernels' meaning (output 0, lse -inf): no dq for the row, and no
    share in any dk or dv.  That is autograd of the plain version, and
    ``jax.grad`` of the reference's, with the row's output gradient
    zeroed; without the zeroing the plain version's dv differs."""
    jax, jnp = _jax()
    from repro.models.common import chunked_attention
    case = EMPTY_ROW_CASE
    causal, window, cap = case[7:10]
    q, k, v, do, lens = _bwd_inputs(case, 3)
    has = _rows_with_a_key(case)
    assert not has.all() and has.any()
    do_kept = do * has[:, :, None, None]
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    o = ref.flash_prefill_ref(tq, tk, tv, _t(lens), **kw)
    auto = torch.autograd.grad(o, (tq, tk, tv), _t(do_kept),
                               retain_graph=True)
    full = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    plain = ref.flash_prefill_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                      o.detach(), _t(do), _t(lens), **kw)
    assert not plain[0][~torch.from_numpy(has)].any()

    def jfn(q, k, v):
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                kv_len=jnp.asarray(lens))
        return jnp.sum(out * jnp.asarray(do_kept))

    jgrad = jax.grad(jfn, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for name, p, a, j in zip("qkv", plain, auto, jgrad):
        scale = float(np.abs(np.asarray(j)).max())
        for other in (a, _t(np.asarray(j))):
            err = float((p - other).abs().max())
            assert err <= BWD_TOL * scale, (name, err, scale)
    assert float((plain[2] - full[2]).abs().max()) > 1e-3 * float(
        full[2].abs().max())


def test_flash_prefill_cpu_autograd_takes_plain_version():
    """On the CPU ``ops.flash_prefill`` differentiates the plain version
    and launches nothing; ``impl="ref"`` does the same anywhere."""
    q, k, v, do, _ = _bwd_inputs(BWD_CASES[0], 1)
    before = (t_flash.flash_prefill.launches,
              t_flash.flash_prefill_bwd.launches)
    grads = []
    for impl in ("auto", "ref"):
        tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
        o = ops.flash_prefill(tq, tk, tv, impl=impl)
        grads.append(torch.autograd.grad(o, (tq, tk, tv), _t(do)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert (t_flash.flash_prefill.launches,
            t_flash.flash_prefill_bwd.launches) == before


# ------------------------------------------------------------ the train step

@pytest.fixture(scope="module")
def mixtral_ref():
    return jax_step_outputs("mixtral-8x7b")


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "olmo-1b"])
def test_train_step_matches_reference(arch, mixtral_ref):
    ref_out = mixtral_ref if arch == "mixtral-8x7b" else \
        jax_step_outputs(arch)
    got = port_step_outputs(ref_out)
    if arch == "mixtral-8x7b":
        assert ref_out["metrics"]["aux_loss"] > 0
    assert_step_matches(ref_out, got)


def test_microbatched_step_matches_full_batch_and_reference():
    """num_micro=2 against the port's full batch (loss within 1e-4, every
    parameter within 1e-5, as ``test_system.py`` holds the reference) and
    against the reference's microbatched step."""
    ref_out = jax_step_outputs("olmo-1b", num_micro=2)
    got = port_step_outputs(ref_out, num_micro=2)
    assert_step_matches(ref_out, got, keys=("loss", "grad_norm"))
    full = port_step_outputs(ref_out)
    np.testing.assert_allclose(got["metrics"]["loss"],
                               full["metrics"]["loss"], rtol=1e-4)
    a, b = dict(_leaves(got["new_params"])), dict(_leaves(full["new_params"]))
    for path in a:
        np.testing.assert_allclose(a[path].detach().numpy(),
                                   b[path].detach().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=str(path))


# --------------------------------------------------------------- on the card

@pytest.fixture
def cuda_fp32():
    """A CUDA device with TF32 off for the f32 plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


CARD_BWD_CASES = BWD_CASES + [
    (1, 64, 64, 8, 8, 192, 128, True, 0, 0.0, None),      # DeepSeek MLA
    (1, 96, 96, 4, 2, 256, 256, True, 40, 30.0, None),    # gemma2
    (2, 130, 130, 4, 2, 64, 64, True, 0, 0.0, (130, 77)),  # ragged tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_BWD_CASES)
def test_flash_prefill_bwd_cuda_matches_plain(cuda_fp32, case, dtype):
    """The gradients through ``ops.flash_prefill`` under autograd (forward
    and backward kernels, one launch each) against autograd of the plain
    version on the same inputs: f32 within 1e-4, bf16 within 2e-2 of each
    gradient's max-abs."""
    dt = getattr(torch, dtype)
    causal, window, cap = case[7:10]
    q, k, v, do, lens = _bwd_inputs(case, 2)
    args = [_t(a).to(cuda_fp32, dt) for a in (q, k, v)]
    tdo = _t(do).to(cuda_fp32, dt)
    tl = None if lens is None else _t(lens).to(cuda_fp32)
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    got, want = [], []
    before = (t_flash.flash_prefill.launches,
              t_flash.flash_prefill_bwd.launches)
    for impl, out in (("auto", got), ("ref", want)):
        xs = [a.clone().requires_grad_(True) for a in args]
        o = ops.flash_prefill(*xs, tl, impl=impl, **kw)
        out.extend(torch.autograd.grad(o, xs, tdo))
    torch.cuda.synchronize()
    assert (t_flash.flash_prefill.launches,
            t_flash.flash_prefill_bwd.launches) == (before[0] + 1,
                                                    before[1] + 1)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dt
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_BWD_CASES + [EMPTY_ROW_CASE])
def test_flash_prefill_bwd_cuda_matches_plain_math(cuda_fp32, case, dtype):
    """The backward kernel alone: given the forward kernel's own o and
    lse, ``flash_prefill_bwd`` against ``ref.flash_prefill_bwd_ref`` fed
    the same o and lse (f32 within 1e-4, bf16 within 2e-2 of each
    gradient's max-abs)."""
    dt = getattr(torch, dtype)
    causal, window, cap = case[7:10]
    q, k, v, do, lens = _bwd_inputs(case, 4)
    q, k, v, do = (_t(a).to(cuda_fp32, dt) for a in (q, k, v, do))
    tl = None if lens is None else _t(lens).to(cuda_fp32)
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    o, lse = t_flash._forward(q, k, v, tl, causal, window, cap, None,
                              with_lse=True)
    got = t_flash.flash_prefill_bwd(q, k, v, o, lse, do, tl, **kw)
    want = ref.flash_prefill_bwd_ref(q, k, v, o, do, tl, lse, **kw)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name, g, w in zip("qkv", got, want):
        scale = float(w.abs().max())
        err = float((g.float() - w).abs().max())
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_bwd_cuda_rows_without_a_key(cuda_fp32, dtype):
    """A query row without a valid key: the forward kernel gives it 0 and
    lse -inf, and the backward gives it no dq and no share in dk or dv —
    the gradients of the plain version with that row's output gradient
    zeroed (f32 within 1e-4, bf16 within 2e-2 of each max-abs).  Keys
    past kv_len get exactly 0."""
    dt = getattr(torch, dtype)
    case = EMPTY_ROW_CASE
    causal, window, cap = case[7:10]
    q, k, v, do, lens = _bwd_inputs(case, 5)
    has = torch.from_numpy(_rows_with_a_key(case)).to(cuda_fp32)
    args = [_t(a).to(cuda_fp32, dt) for a in (q, k, v)]
    tdo = _t(do).to(cuda_fp32, dt)
    tl = _t(lens).to(cuda_fp32)
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    o, lse = t_flash._forward(*args, tl, causal, window, cap, None,
                              with_lse=True)
    assert not o[~has].any()
    assert torch.isneginf(lse.transpose(1, 2)[~has]).all()
    xs = [a.clone().requires_grad_(True) for a in args]
    got = torch.autograd.grad(ops.flash_prefill(*xs, tl, **kw), xs, tdo)
    xs = [a.clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(ops.flash_prefill(*xs, tl, impl="ref", **kw),
                               xs, tdo * has[:, :, None, None].to(dt))
    assert not got[0][~has].any()
    past = torch.arange(case[2], device=cuda_fp32)[None, :] >= tl[:, None]
    assert not got[1][past].any() and not got[2][past].any()
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name, g, w in zip("qkv", got, want):
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.cuda
def test_flash_prefill_bwd_cuda_refuses_what_does_not_fit(cuda_fp32):
    """A head width whose tiles pass a block's shared memory raises; it
    does not fall back to the plain version."""
    q = torch.zeros((1, 16, 1, 512), device=cuda_fp32, requires_grad=True)
    k = torch.zeros((1, 16, 1, 512), device=cuda_fp32, requires_grad=True)
    v = torch.zeros((1, 16, 1, 512), device=cuda_fp32, requires_grad=True)
    o = ops.flash_prefill(q, k, v)
    with pytest.raises(ValueError, match="shared memory"):
        o.sum().backward()
