"""The port's census (``core/census.py``) against the JAX package's, on the
CPU: FLOPs, HBM bytes and every kind of collective bytes within 1e-12
relative, for each of the 11 configs, each shape ``shape_applicable``
admits for it and the meshes of ``test_torch_sharding.py``, without a plan
and with each package's own plan.  Then ``test_census.py``'s five
closed-form tests on the port."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.census import census as j_census  # noqa: E402
from repro.core.roofline import model_flops_for  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.core.census import census  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from test_torch_sharding import CASES, MESHES, _meshes  # noqa: E402

REL = 1e-12


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


def _same(got, want) -> None:
    assert _close(got.flops, want.flops), (got.flops, want.flops)
    assert _close(got.hbm_bytes, want.hbm_bytes), (got.hbm_bytes,
                                                   want.hbm_bytes)
    assert set(got.coll_bytes) == set(want.coll_bytes)
    for k in want.coll_bytes:
        assert _close(got.coll_bytes[k], want.coll_bytes[k]), k


@pytest.mark.parametrize("arch,shape,mesh", CASES)
@pytest.mark.parametrize("with_plan", [False, True])
def test_census_matches_jax(arch, shape, mesh, with_plan):
    sizes, names = MESHES[mesh]
    mesh_shape = dict(zip(names, sizes))
    cfg, jcfg = get_config(arch), j_get_config(arch)
    plan = jplan = None
    if with_plan:
        m, fm = _meshes(mesh)
        plan = SH.make_plan(cfg, get_shape(shape), m)
        jplan = JSH.make_plan(jcfg, SHAPES[shape], fm)
    _same(census(cfg, get_shape(shape), mesh_shape, plan),
          j_census(jcfg, SHAPES[shape], mesh_shape, jplan))


MESH = {"data": 16, "model": 16}


def test_census_flops_closed_form_dense():
    """olmo decode: census FLOPs = 2 * N_active * D (weights) + the
    32k-context attention term 4 * B * H * Dh * S * L (the reference's
    ``model_flops_for`` is the yardstick)."""
    cfg = get_config("olmo-1b")
    shape = get_shape("decode_32k")
    c = census(cfg, shape, MESH)
    mf = model_flops_for(j_get_config("olmo-1b"), SHAPES["decode_32k"])
    attn = (4 * shape.global_batch * cfg.num_heads * cfg.head_dim
            * shape.seq_len * cfg.num_layers)
    assert 0.85 * (mf + attn) < c.flops < 1.3 * (mf + attn)


def test_census_train_multiplier():
    cfg = get_config("olmo-1b")
    tr = census(cfg, get_shape("train_4k"), MESH)
    pf = census(cfg, dataclasses.replace(get_shape("train_4k"),
                                         mode="prefill"), MESH)
    assert 2.5 < tr.flops / pf.flops < 3.5


def test_census_int8_experts_halve_weight_bytes():
    cfg = get_config("mixtral-8x7b")
    shape = get_shape("decode_32k")
    base = census(cfg, shape, MESH)
    q = census(dataclasses.replace(cfg, expert_dtype="int8"), shape, MESH)
    # expert weights dominate mixtral decode: more than 30 % less
    assert q.hbm_bytes < 0.7 * base.hbm_bytes


def test_census_int8_kv_reduces_bytes():
    cfg = get_config("olmo-1b")            # fat KV (MHA kv=16)
    shape = get_shape("decode_32k")
    base = census(cfg, shape, MESH)
    q = census(dataclasses.replace(cfg, kv_dtype="int8"), shape, MESH)
    assert q.hbm_bytes < base.hbm_bytes


def test_census_collectives_scale_with_pod():
    cfg = get_config("olmo-1b")
    c1 = census(cfg, get_shape("train_4k"), MESH)
    c2 = census(cfg, get_shape("train_4k"),
                {"pod": 2, "data": 16, "model": 16})
    assert "all-reduce(pod)" not in c1.coll_bytes
    assert c2.coll_bytes.get("all-reduce(pod)", 0) > 0
