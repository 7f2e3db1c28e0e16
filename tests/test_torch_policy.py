"""The port's performance model (``core/hrm.py``), policy search
(``core/policy.py``) and CGOPipe simulator (``core/cgopipe.py``) against the
JAX package's — all pure arithmetic, so equal within 1e-12 relative.

  * ``memory_usage``, ``estimate`` (dense and ``kv_paged``, with a measured
    ``expert_popularity``, ``module_groups`` and ``predict_lookahead``) and
    ``layer_latency`` on mixtral-8x7b, qwen2.5-3b and deepseek-v3-671b, for
    each of the reference's presets.
  * ``search`` for mixtral (``kv_paged``) and qwen2.5 on ``l4`` and ``t4``
    picks the same policies; deepseek-v3 raises the same RuntimeError.
  * ``run_schedule`` and ``per_layer_latency`` for every schedule.
  * The paper's properties of ``test_hrm.py`` and ``test_cgopipe.py``, on
    the port's functions.
  * The ``h100`` preset's GPU level (the data sheet), and
    ``with_measured_links`` reading a transfer artifact.
"""
import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.core import cgopipe as JCG  # noqa: E402
from repro.core import hrm as JH  # noqa: E402
from repro.core import policy as JP  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import cgopipe as CG  # noqa: E402
from repro_torch.core import hrm as H  # noqa: E402
from repro_torch.core import policy as P  # noqa: E402

REL = 1e-12
ARCHS = ("mixtral-8x7b", "qwen2.5-3b", "deepseek-v3-671b")
PRESETS = ("t4", "l4", "a100x2", "v5e")
SKEW = np.array([0.5, 0.3, 0.1, 0.04, 0.03, 0.02, 0.005, 0.005])


def _close(a, b):
    """Equal within REL relative, key by key for dicts."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, float) and (np.isinf(a) or np.isinf(b)):
        assert a == b
    else:
        assert a == pytest.approx(b, rel=REL, abs=0), (a, b)


def _policies(arch):
    """A spread of policies, both packages' Policy classes."""
    cfg = t_get_config(arch)
    pops = [None]
    if cfg.is_moe:
        rng = np.random.default_rng(len(arch))
        pops.append(rng.random((cfg.num_layers, cfg.num_experts)))
    kw = [dict(batch=256, ubatch=32, attn_on_gpu=False, ffn_on_gpu=True,
               w_gpu_ratio=0.25, kv_gpu_ratio=0.0),
          dict(batch=512, ubatch=64, attn_on_gpu=True, ffn_on_gpu=True,
               w_gpu_ratio=0.5, kv_gpu_ratio=0.25, module_groups=2),
          dict(batch=64, ubatch=16, attn_on_gpu=True, ffn_on_gpu=False,
               w_gpu_ratio=0.0, kv_gpu_ratio=1.0),
          dict(batch=1024, ubatch=128, attn_on_gpu=True, ffn_on_gpu=True,
               w_gpu_ratio=0.1, kv_gpu_ratio=0.1, predict_lookahead=2,
               replicate_frac=0.25)]
    return [(JP.Policy(**k), P.Policy(**k), pop) for k in kw for pop in pops]


# ----------------------------------------------------------- HRM + policy

@pytest.mark.parametrize("arch", ARCHS)
def test_memory_estimate_latency_match_jax(arch):
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    assert P.model_bytes(tcfg) == JP.model_bytes(jcfg)
    assert P.kv_bytes_per_token_layer(tcfg) == \
        JP.kv_bytes_per_token_layer(jcfg)
    jwl, twl = JP.Workload(77, 32), P.Workload(77, 32)
    assert twl.avg_ctx == jwl.avg_ctx
    for name in PRESETS:
        jhw, thw = JH.preset(name), H.preset(name)
        for jpol, tpol, pop in _policies(arch):
            assert tpol.num_ubs == jpol.num_ubs
            _close(P.memory_usage(tcfg, twl, tpol),
                   JP.memory_usage(jcfg, jwl, jpol))
            for kw in (dict(), dict(kv_paged=True, block_tokens=16),
                       dict(kv_hit_rate=0.7, predictor_accuracy=0.6),
                       dict(kv_paged=True, expert_popularity=pop,
                            predictor_accuracy=0.8)):
                _close(P.estimate(tcfg, thw, twl, tpol, **kw),
                       JP.estimate(jcfg, jhw, jwl, jpol, **kw))
            for batch, ctx in ((1, 100.0), (256, 512.5)):
                tlw = H.LayerWorkload.decode(tcfg, batch, ctx,
                                             popularity=pop, kv_hit=0.4,
                                             block_tokens=16,
                                             predictor_accuracy=0.5)
                jlw = JH.LayerWorkload.decode(jcfg, batch, ctx,
                                              popularity=pop, kv_hit=0.4,
                                              block_tokens=16,
                                              predictor_accuracy=0.5)
                for f in dataclasses.fields(jlw):
                    if f.name != "popularity":
                        _close(getattr(tlw, f.name), getattr(jlw, f.name))
                _close(tlw.intensity_attn_vs_kv(), jlw.intensity_attn_vs_kv())
                _close(tlw.intensity_ffn_vs_weights(),
                       jlw.intensity_ffn_vs_weights())
                _close(H.layer_latency(thw, tlw, tpol),
                       JH.layer_latency(jhw, jlw, jpol))


@pytest.mark.parametrize("name", PRESETS)
def test_presets_and_roofline_match_jax(name):
    t, j = H.preset(name), JH.preset(name)
    assert [dataclasses.astuple(lv) for lv in t.levels] == \
        [dataclasses.astuple(lv) for lv in j.levels]
    assert t.links == j.links and t.name == j.name
    other = [lv.name for lv in j.levels if lv.name != "gpu"]
    for i in (0.01, 1.0, 4.0, 100.0, 1e6):
        _close(H.attainable_local(t, "gpu", i),
               JH.attainable_local(j, "gpu", i))
        for lv in other:
            _close(H.attainable_local(t, lv, i), JH.attainable_local(j, lv, i))
            _close(H.attainable_cross(t, "gpu", lv, 50.0, i),
                   JH.attainable_cross(j, "gpu", lv, 50.0, i))
            _close(H.turning_point_p1(t, "gpu", lv, i),
                   JH.turning_point_p1(j, "gpu", lv, i))
            _close(H.turning_point_p2(t, "gpu", lv, i),
                   JH.turning_point_p2(j, "gpu", lv, i))
            _close(H.balance_point_intensity(t, "gpu", lv, i),
                   JH.balance_point_intensity(j, "gpu", lv, i))
            assert H.should_compute_at_data(t, "gpu", lv, i) == \
                JH.should_compute_at_data(j, "gpu", lv, i)


def test_hit_rates_match_jax():
    rng = np.random.default_rng(7)
    pops = [None, SKEW, rng.random((4, 8)), np.zeros((2, 8))]
    for r in (-0.5, 0.0, 0.1, 0.25, 0.5, 0.9, 1.0, 1.5):
        for nub in (1, 2, 3, 8):
            assert H.kv_block_hit_rate(r, nub) == JH.kv_block_hit_rate(r, nub)
        for pop in pops:
            for rf in (None, 0.0, 0.25, 1.0):
                for acc, la in ((0.0, 0), (0.7, 1), (0.7, 3)):
                    kw = dict(predictor_accuracy=acc, predict_lookahead=la,
                              replicate_frac=rf)
                    _close(H.expert_hit_rate(r, 8, pop, **kw),
                           JH.expert_hit_rate(r, 8, pop, **kw))
        _close(H.expert_hit_rate(r, 0), JH.expert_hit_rate(r, 0))


@pytest.fixture(scope="module")
def searches():
    """The port's and the reference's searches (2-4 s a call)."""
    cases = {("mixtral-8x7b", "l4"): dict(kv_paged=True),
             ("mixtral-8x7b", "t4"): dict(kv_paged=True),
             ("qwen2.5-3b", "l4"): dict(),
             ("qwen2.5-3b", "t4"): dict()}
    out = {}
    for (arch, hw), kw in cases.items():
        out[arch, hw] = (
            P.search(t_get_config(arch), H.preset(hw), P.Workload(77, 32),
                     **kw),
            JP.search(get_config(arch), JH.preset(hw), JP.Workload(77, 32),
                      **kw))
    return out


@pytest.mark.parametrize("arch,hw", [("mixtral-8x7b", "l4"),
                                     ("mixtral-8x7b", "t4"),
                                     ("qwen2.5-3b", "l4"),
                                     ("qwen2.5-3b", "t4")])
def test_search_matches_jax(searches, arch, hw):
    got, want = searches[arch, hw]
    for key in ("best", "best_gpu_attn", "best_cpu_attn"):
        g, w = dict(got[key]), dict(want[key])
        assert dataclasses.asdict(g.pop("policy")) == \
            dataclasses.asdict(w.pop("policy"))
        _close(g, w)


def test_search_infeasible_matches_jax():
    """DeepSeek-V3 fits neither L4 nor T4 with its host: both raise."""
    with pytest.raises(RuntimeError) as want:
        JP.search(get_config("deepseek-v3-671b"), JH.preset("l4"),
                  JP.Workload(77, 32))
    with pytest.raises(RuntimeError) as got:
        P.search(t_get_config("deepseek-v3-671b"), H.preset("l4"),
                 P.Workload(77, 32))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- CGOPipe

def _step_times(arch):
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    out = []
    for name in ("l4", "t4", "a100x2"):
        for jpol, tpol, _ in _policies(arch)[::2]:
            jt = JCG.times_from_policy(jcfg, JH.preset(name),
                                       JP.Workload(77, 64), jpol)
            tt = CG.times_from_policy(tcfg, H.preset(name),
                                      P.Workload(77, 64), tpol)
            out.append((tt, jt))
    return out


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen2.5-3b"])
def test_schedules_match_jax(arch):
    for tt, jt in _step_times(arch):
        _close(dataclasses.asdict(tt), dataclasses.asdict(jt))
        for name in JCG.BUILDERS:
            a = CG.run_schedule(name, tt, 4)
            b = JCG.run_schedule(name, jt, 4)
            _close(a.makespan, b.makespan)
            _close(a.busy, b.busy)
            _close(a.starts, b.starts)
            _close(a.ends, b.ends)
            _close(CG.per_layer_latency(name, tt, 8),
                   JCG.per_layer_latency(name, jt, 8))


# ---------------------------------------- the paper's properties, on the port

@pytest.fixture(scope="module")
def mixtral():
    return t_get_config("mixtral-8x7b")


@pytest.fixture(scope="module")
def l4():
    return H.preset("l4")


def test_roofline_and_turning_points(l4):
    assert H.attainable_local(l4, "gpu", 0.001) == pytest.approx(300e9 * 0.001)
    assert H.attainable_local(l4, "gpu", 1e9) == l4.level("gpu").p_peak
    assert H.attainable_cross(l4, "gpu", "cpu", i_exec=1e9, i_data=1.0) == \
        pytest.approx(l4.link_bw("cpu", "gpu"))
    assert H.turning_point_p1(l4, "gpu", "cpu", 10.0) < \
        H.turning_point_p2(l4, "gpu", "cpu", 10.0)
    i_j = H.balance_point_intensity(l4, "gpu", "cpu", i_exec=10.0)
    assert l4.level("gpu").b_peak * 10.0 == \
        pytest.approx(l4.link_bw("cpu", "gpu") * i_j)


def test_paper_fig4_fig5(mixtral, l4):
    """Fig. 4: decode attention is below P1 on the L4 (compute on the CPU);
    Fig. 5: the FFN's intensity grows with the batch."""
    lw = H.LayerWorkload.decode(mixtral, batch=256, ctx=512)
    assert H.should_compute_at_data(l4, "gpu", "cpu",
                                    lw.intensity_attn_vs_kv())
    i = [H.LayerWorkload.decode(mixtral, batch=n, ctx=576)
         .intensity_ffn_vs_weights() for n in (32, 128, 512, 2048)]
    assert i == sorted(i) and i[-1] > 10 * i[0]


def test_paper_search_properties(searches, l4):
    """§4.2 'we always get A_g=0 and F_g=1'; the CPU-attention optimum
    beats the forced GPU-attention one; the memory constraints hold."""
    res, _ = searches["mixtral-8x7b", "l4"]
    best = res["best"]["policy"]
    assert best.attn_on_gpu is False and best.ffn_on_gpu is True
    assert res["best_cpu_attn"]["throughput"] >= \
        res["best_gpu_attn"]["throughput"] > 0
    for r in res.values():
        assert r["mem_gpu"] <= l4.level("gpu").capacity
        assert r["mem_cpu"] <= l4.level("cpu").capacity


def test_fig10_more_link_bw_more_offload(mixtral):
    """§6.3: more CPU→GPU bandwidth moves weights toward the CPU (r_w
    falls or stays) on the 2xA100 preset (a coarser grid than the
    default, to keep the sweep short)."""
    base = H.preset("a100x2")
    rws = []
    for bw in (25e9, 100e9, 400e9):
        hw = H.Hardware(levels=base.levels, links={("cpu", "gpu"): bw})
        res = P.search(mixtral, hw, P.Workload(512, 32),
                       ub_grid=(16, 64, 256), mult_grid=(1, 4, 16, 64))
        rws.append(res["best"]["policy"].w_gpu_ratio)
    assert rws[-1] <= rws[0]


def test_hit_rate_properties(mixtral, l4):
    for r in (0.0, 0.25, 0.5, 1.0):
        assert H.expert_hit_rate(r, 8) == pytest.approx(r)
        assert H.kv_block_hit_rate(r, 1) == pytest.approx(r)
    assert H.expert_hit_rate(0.25, 8, SKEW) == pytest.approx(0.8)
    assert H.kv_block_hit_rate(0.25, 2) == pytest.approx(0.5)
    assert H.kv_block_hit_rate(0.9, 4) == 1.0
    # measured skew and a paged KV hit rate each cut the link bytes
    pol = P.Policy(256, 32, True, True, 0.25, 0.25)
    wl = H.LayerWorkload.decode(mixtral, batch=256, ctx=512)
    base = H.layer_latency(l4, wl, pol)["comm_bytes"]
    assert base == pytest.approx(wl.bytes_kv * 0.75 + wl.bytes_w * 0.75)
    assert H.layer_latency(l4, dataclasses.replace(wl, popularity=SKEW),
                           pol)["comm_bytes"] < base
    assert H.layer_latency(l4, dataclasses.replace(
        wl, kv_hit=H.kv_block_hit_rate(0.25, 4)), pol)["comm_bytes"] < base


def test_simulator_and_fig6_properties(mixtral, l4):
    r = CG.simulate([CG.Task("a", "gpu", 1.0),
                     CG.Task("b", "gpu", 1.0, ("a",)),
                     CG.Task("c", "h2d", 0.5, ("a",)),
                     CG.Task("d", "gpu", 1.0, ("c",))])
    assert r.makespan == pytest.approx(3.0)
    with pytest.raises(ValueError):
        CG.simulate([CG.Task("a", "gpu", 1.0, ("b",)),
                     CG.Task("b", "gpu", 1.0, ("a",))])
    t = CG.times_from_policy(mixtral, l4, P.Workload(77, 64),
                             P.Policy(128, 32, False, True, 0.0, 0.0))
    lat = {n: CG.per_layer_latency(n, t, 16)
           for n in ("cgopipe", "s2", "s3", "s4")}
    assert lat["cgopipe"] <= lat["s2"] * 1.001
    assert lat["cgopipe"] < lat["s3"] and lat["cgopipe"] < lat["s4"]
    wb = CG.times_from_policy(mixtral, l4, P.Workload(77, 64),
                              P.Policy(32, 8, False, True, 0.0, 0.0))
    res = {s: CG.run_schedule(s, wb, 8) for s in ("cgopipe", "s2", "s3")}
    assert res["cgopipe"].makespan <= res["s2"].makespan \
        <= res["s3"].makespan
    assert res["cgopipe"].utilization("gpu") >= \
        res["s2"].utilization("gpu") > res["s3"].utilization("gpu")


# ----------------------------------------------------------------- H100

def test_h100_preset_gpu_level():
    hw = H.preset("h100")
    gpu = hw.level("gpu")
    assert (gpu.p_peak, gpu.b_peak, gpu.capacity) == (989e12, 3.35e12, 80e9)
    assert hw.link_bw("cpu", "gpu") > 0 and hw.level("cpu").capacity > 0
    # a feasible GPU-attention policy for mixtral at full depth (what the
    # engine runs; chip_smoke.py searches with the card's measured link)
    res = P.search(t_get_config("mixtral-8x7b"), hw, P.Workload(144, 32),
                   kv_paged=True, ub_grid=(8, 16, 64),
                   mult_grid=(1, 2, 16, 64), module_groups_grid=(1, 2))
    assert res["best_gpu_attn"]["policy"].attn_on_gpu


def test_with_measured_links(tmp_path):
    hw = H.preset("h100")
    path = tmp_path / "transfer.json"
    assert H.with_measured_links(hw, str(path)) is hw        # no artifact
    path.write_text("not json")
    assert H.measured_link_bw(str(path)) is None
    path.write_text(json.dumps({"h2d_pinned_bytes_per_s": None,
                                "h2d_pageable_bytes_per_s": 12.5e9}))
    assert H.measured_link_bw(str(path)) == 12.5e9
    path.write_text(json.dumps({"h2d_pinned_bytes_per_s": 51.3e9}))
    got = H.with_measured_links(hw, str(path))
    assert got.link_bw("cpu", "gpu") == 51.3e9
    assert got.levels == hw.levels and got.name == "h100+measured"
    want = JH.with_measured_links(JH.preset("l4"), str(path))
    assert H.with_measured_links(H.preset("l4"), str(path)).links == \
        want.links
