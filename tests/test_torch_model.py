"""The port's model layers against the JAX package on the same weights.

JAX parameters from ``repro.models.params.init_params`` reach the port
through numpy (``repro_torch.models.convert.params_from_numpy``); both run in
float32 on the CPU.  The JAX side runs ``ExecPolicy(moe_impl="grouped",
use_kernels=False)``; the port runs the slice's grouped policy with and
without its kernel wrappers (on CPU tensors both take the plain versions).
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
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = 1e-4         # f32 end to end; the two frameworks sum in other orders
ARCHS = ["mixtral-8x7b", "qwen2.5-3b"]
MAX_SEQ = 32


def _cfgs(arch):
    jc = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    tc = dataclasses.replace(t_get_config(arch).smoke(), dtype="float32")
    return jc, tc


@pytest.fixture(scope="module")
def reference():
    """Per arch: configs, both packages' params, and the JAX logits of a
    train forward, a prefill and three decode steps on seeded tokens."""
    out = {}
    policy = jmodel.ExecPolicy(moe_impl="grouped", use_kernels=False)
    for i, arch in enumerate(ARCHS):
        jc, tc = _cfgs(arch)
        params = jparams.init_params(jc, jax.random.key(i))
        rng = np.random.default_rng(10 + i)
        prompt = rng.integers(2, jc.vocab_size, (2, 12)).astype(np.int32)
        steps = rng.integers(2, jc.vocab_size, (3, 2, 1)).astype(np.int32)
        fwd = jmodel.forward(jc, params, jnp.asarray(prompt), policy=policy)
        logits = {"train": jmodel.unembed(jc, params, fwd["hidden"])}
        cache = jkv.init_cache(jc, 2, MAX_SEQ)
        fwd = jmodel.forward(jc, params, jnp.asarray(prompt), cache=cache,
                             mode="prefill", policy=policy)
        logits["prefill"] = jmodel.unembed(jc, params, fwd["hidden"])
        cache = fwd["cache"]
        for s, tok in enumerate(steps):
            fwd = jmodel.forward(jc, params, jnp.asarray(tok), cache=cache,
                                 mode="decode", policy=policy)
            logits[f"decode{s}"] = jmodel.unembed(jc, params, fwd["hidden"])
            cache = fwd["cache"]
        out[arch] = dict(
            jc=jc, tc=tc, params=params, prompt=prompt, steps=steps,
            tparams=params_from_numpy(jax.tree.map(np.asarray, params),
                                      device="cpu"),
            logits={k: np.asarray(v) for k, v in logits.items()})
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_counts_match_jax(arch):
    jc, tc = _cfgs(arch)
    want = jax.tree_util.tree_leaves_with_path(jparams.abstract_params(jc))
    got = tparams.init_params(tc, torch.Generator().manual_seed(0),
                              device="cpu")
    flat = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = v
    walk(got, ())
    assert len(flat) == len(want)
    for path, leaf in want:
        t = flat[tuple(p.key for p in path)]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)
    full_j, full_t = get_config(arch), t_get_config(arch)
    for active in (False, True):
        assert tparams.count_params(full_t, active_only=active) == \
            jparams.count_params(full_j, active_only=active)
    assert full_t.param_count() == full_j.param_count()


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
        np.testing.assert_allclose(got[k].numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert cache["pos"].tolist() == [12 + len(r["steps"])] * 2


@pytest.mark.parametrize("use_kernel", [False, True])
def test_moe_paths_match_jax(reference, use_kernel):
    r = reference["mixtral-8x7b"]
    jc, tc = r["jc"], r["tc"]
    p = r["params"]["blocks"]["p0"]["moe"]
    jp = jax.tree.map(lambda a: a[0], p)
    tp = {k: v[0] for k, v in r["tparams"]["blocks"]["p0"]["moe"].items()}
    x = np.random.default_rng(3).normal(0, 1, (12, jc.d_model)).astype(
        np.float32)
    want, want_aux = jmoe.moe_grouped(jc, jp, jnp.asarray(x))
    got, got_aux = tmoe.moe_grouped(tc, tp, torch.from_numpy(x),
                                    use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=TOL)
    want_d, _ = jmoe.moe_dense(jc, jp, jnp.asarray(x))
    got_d, _ = tmoe.moe_dense(tc, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_stage_bucket_matches_jax(groups):
    dest = np.random.default_rng(4).integers(-1, 4, (24,)).astype(np.int32)
    ws, wk = jmoe.stage_bucket(jnp.asarray(dest), 4, 3, groups)
    gs, gk = tmoe.stage_bucket(torch.from_numpy(dest).long(), 4, 3, groups)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gs.numpy()[gk.numpy()],
                                  np.asarray(ws)[np.asarray(wk)])


def test_slot_ops_match_jax():
    """reset_slot / insert_slot / write_decode on the dense ring: the port's
    in-place updates land exactly where the JAX package's functional ones
    do."""
    jc, tc = _cfgs("qwen2.5-3b")
    rng = np.random.default_rng(5)
    jpool = jkv.init_cache(jc, 3, 16)
    tpool = tkv.init_cache(tc, 3, 16, device="cpu")
    single = {"pos": np.array([5], np.int32), "p0": {
        "k": rng.normal(0, 1, jpool["p0"]["k"][:, :1].shape).astype(np.float32),
        "v": rng.normal(0, 1, jpool["p0"]["v"][:, :1].shape).astype(np.float32),
        "slot_pos": np.tile(np.arange(16, dtype=np.int32), (jc.num_periods, 1, 1))}}
    jpool = jkv.insert_slot(jpool, jax.tree.map(jnp.asarray, single), 1)
    tkv.insert_slot(tpool, {"pos": torch.from_numpy(single["pos"]),
                            "p0": {k: torch.from_numpy(v)
                                   for k, v in single["p0"].items()}}, 1)
    new = {n: rng.normal(0, 1, (3, 1, jc.num_kv_heads, jc.head_dim)).astype(
        np.float32) for n in ("k", "v")}
    pos = np.array([3, 17, 0], np.int32)
    layer = jax.tree.map(lambda a: a[0], jpool["p0"])
    layer = jkv.write_decode(layer, jax.tree.map(jnp.asarray, new),
                             jnp.asarray(pos))
    tlayer = {k: v[0] for k, v in tpool["p0"].items()}
    tkv.write_decode(tlayer, {k: torch.from_numpy(v) for k, v in new.items()},
                     torch.from_numpy(pos))
    for name in ("k", "v", "slot_pos"):
        np.testing.assert_array_equal(tpool["p0"][name][0].numpy(),
                                      np.asarray(layer[name]))
    jpool = jkv.reset_slot(jpool, 1)
    tkv.reset_slot(tpool, 1)
    np.testing.assert_array_equal(tpool["pos"].numpy(),
                                  np.asarray(jpool["pos"]))
    np.testing.assert_array_equal(tpool["p0"]["slot_pos"][:, 1].numpy(),
                                  np.asarray(jpool["p0"]["slot_pos"][:, 1]))
