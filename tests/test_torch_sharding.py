"""The port's sharding plans against the JAX package's, on the CPU.

For each of the 11 configs, each shape of ``SHAPES`` that
``shape_applicable`` admits for it, and the meshes (1,1), (2,4), 16x16 and
2x16x16 (names and sizes only: a port ``Mesh`` without a process group,
and on the reference's side ``test_sharding.py``'s ``FakeMesh``), the
port's ``make_plan`` equals the reference's: rules, dp, KV and expert
axes, the MoE variant, which policy fields are set, and every leaf of
``param_specs`` and ``cache_specs``.  A reference ``PartitionSpec`` is
compared as a tuple with its trailing Nones dropped, as the port's
``Spec`` stores it.  Mirrors of ``test_sharding.py``'s plan tests, and
``shard_tree`` against numpy blocks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import ALL_ARCHS, SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import shape_applicable  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.models import kvcache as j_kvcache  # noqa: E402
from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CASES = [(a, s, m) for a in ALL_ARCHS for s in SHAPES for m in MESHES
         if shape_applicable(j_get_config(a), SHAPES[s])[0]]
# a cache tree this small still has every leaf kind of the shape's config
CACHE_B, CACHE_S = 4, 64


class FakeMesh:
    """Names and sizes, all the reference's plan reads of a mesh."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def _meshes(name):
    sizes, names = MESHES[name]
    return Mesh(sizes, names), FakeMesh(dict(zip(names, sizes)))


def _spec(p) -> tuple:
    """A reference PartitionSpec (which stores a one-axis tuple as its
    axis) as the port's Spec stores it."""
    parts = [tuple(x) if isinstance(x, list) else x for x in tuple(p)]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _plans(arch, shape, mesh):
    m, fm = _meshes(mesh)
    got = SH.make_plan(get_config(arch), get_shape(shape), m)
    want = JSH.make_plan(j_get_config(arch), SHAPES[shape], fm)
    return got, want, m, fm


@pytest.mark.parametrize("arch,shape,mesh", CASES)
def test_make_plan_matches_jax(arch, shape, mesh):
    got, want, m, fm = _plans(arch, shape, mesh)
    assert {k: (tuple(v) if isinstance(v, (tuple, list)) else v)
            for k, v in got.rules.items()} == \
        {k: (tuple(v) if isinstance(v, (tuple, list)) else v)
         for k, v in want.rules.items()}
    assert got.dp_axes == tuple(want.dp_axes)
    assert got.kv_axes == tuple(want.kv_axes)
    assert got.expert_axes == tuple(want.expert_axes)
    assert got.moe_variant == want.moe_variant
    gp, wp = got.policy, want.policy
    assert (gp.moe_impl, gp.use_kernels, gp.remat) == \
        (wp.moe_impl, wp.use_kernels, wp.remat)
    assert (gp.moe_fn is None, gp.attn_fn is None) == \
        (wp.moe_fn is None, wp.attn_fn is None)
    g_leaves = list(_leaves(got.param_specs))
    w_leaves = list(_leaves(want.param_specs))
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
    for (path, g), (_, w) in zip(g_leaves, w_leaves):
        assert isinstance(g, SH.Spec)
        assert tuple(g) == _spec(w), path


@pytest.mark.parametrize("arch,shape,mesh",
                         [c for c in CASES if SHAPES[c[1]].mode == "decode"])
def test_cache_specs_match_jax(arch, shape, mesh):
    got, want, m, fm = _plans(arch, shape, mesh)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    cache = kvcache.init_cache(cfg, CACHE_B, CACHE_S, device="meta")
    jcache = jax.eval_shape(lambda: j_kvcache.init_cache(jcfg, CACHE_B,
                                                         CACHE_S))
    g = SH.cache_specs(cfg, cache, got.dp_axes, got.kv_axes, got.rules, m)
    w = JSH.cache_specs(jcfg, jcache, want.dp_axes, want.kv_axes,
                        want.rules, fm)
    g_leaves, w_leaves = list(_leaves(g)), list(_leaves(w))
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
    for (path, gs), (_, ws) in zip(g_leaves, w_leaves):
        assert tuple(gs) == _spec(ws), path


def test_expert_axis_choice():
    """``test_sharding.py::test_expert_axis_choice`` on the port."""
    m = make_production_mesh()
    axes, ffn_data = SH.expert_sharding_for(get_config("deepseek-v3-671b"),
                                            m)
    assert axes == ("data", "model") and not ffn_data
    axes, _ = SH.expert_sharding_for(get_config("moonshot-v1-16b-a3b"), m)
    assert axes == ("model",)
    axes, ffn_data = SH.expert_sharding_for(
        get_config("jamba-1.5-large-398b"), m)
    assert axes == ("model",) and ffn_data    # 43 GB a chip -> shard ffn
    axes, _ = SH.expert_sharding_for(get_config("mixtral-8x7b"), m)
    assert axes == ()                          # 8 experts can't split 16


def test_spec_divisibility_guard():
    """whisper's vocab 51865 is odd: it shards over a 1-wide axis only."""
    rules = {"vocab": "model"}
    spec = SH.spec_for_axes(("vocab", "embed"), (51865, 768), rules,
                            Mesh((1,), ("model",)))
    assert spec == SH.Spec("model")
    spec = SH.spec_for_axes(("vocab", "embed"), (51865, 768), rules,
                            Mesh((16,), ("model",)))
    assert spec == SH.Spec() and tuple(spec) == ()


def test_make_plan_smoke():
    """``test_sharding.py::test_make_plan_smoke``: mixtral's decode plan on
    a (1, 1) mesh, every param spec a Spec; the (1, 1) plans chip_smoke.py
    serves under."""
    cfg = get_config("mixtral-8x7b")
    plan = SH.make_plan(cfg, get_shape("decode_32k"),
                        Mesh((1, 1), ("data", "model")))
    assert plan.moe_variant == "grouped_pjit"
    assert plan.policy.moe_impl == "grouped" and plan.policy.attn_fn
    assert all(isinstance(s, SH.Spec) for _, s in _leaves(plan.param_specs))
    plan = SH.make_plan(cfg, get_shape("decode_32k"), Mesh((1,), ("model",)))
    assert plan.moe_variant == "ep_psum" and plan.policy.moe_fn
    plan = SH.make_plan(cfg, get_shape("train_4k"), Mesh((1,), ("model",)))
    assert plan.moe_variant == "ep_a2a" and plan.policy.remat


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_match_jax(mesh):
    """Every batch leaf's rows over the plan's dp axes (train and decode
    plans of mixtral give dp ("data",), ("pod", "data") or none)."""
    for shape in ("train_4k", "decode_32k", "long_500k"):
        got, want, _, _ = _plans("mixtral-8x7b", shape, mesh)
        batch = {"tokens": np.zeros((4, 8)), "targets": np.zeros((4, 8)),
                 "frames": np.zeros((4, 8, 2))}
        g = SH.batch_specs(batch, got.dp_axes)
        w = JSH.batch_specs(batch, want.dp_axes)
        assert {k: tuple(v) for k, v in g.items()} == \
            {k: _spec(v) for k, v in w.items()}


def test_spec_normalizes_as_partition_spec():
    from jax.sharding import PartitionSpec as P
    for parts in [(None,), ("data", None), (("data",), None, "model"),
                  (("pod", "data"), None), ()]:
        assert tuple(SH.Spec(*parts)) == _spec(P(*parts))


@pytest.mark.parametrize("spec", [SH.Spec(), SH.Spec("model"),
                                  SH.Spec(None, ("data", "model")),
                                  SH.Spec("data", "model")])
def test_shard_tree_gives_each_rank_its_block(spec):
    """``shard_tree`` on a (2, 4) mesh: rank r's slice is the numpy block
    at its coordinates (a tuple of axes splits major to minor)."""
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    seen = []
    for rank in range(8):
        mesh = Mesh((2, 4), ("data", "model"), rank=rank)
        got = SH.shard_tree({"a": {"w": torch.from_numpy(x)}},
                            {"a": {"w": spec}}, mesh)["a"]["w"].numpy()
        want = x
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            n = mesh.axis_size(axes)
            want = np.split(want, n, axis=dim)[mesh.axis_index(axes)]
        np.testing.assert_array_equal(got, want)
        seen.append(got.copy())
    if len(spec) == 1 and spec[0] == "model":
        # the four model blocks tile x along dim 0, for either data row
        np.testing.assert_array_equal(np.concatenate(seen[:4]), x)
