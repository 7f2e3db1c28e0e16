"""``tests/test_configs.py`` mirrored on the port's config registry
(``repro_torch.configs``): every arch loads with its published numbers,
parameter counts match the public figures, the shape applicability
matrix, the reduced smoke configs; plus ``count_params`` (total and
active, with and without the embeddings) equal to the JAX package's for
every arch, full and smoke (arithmetic on the parameter definitions;
nothing is allocated)."""
import pytest

pytest.importorskip("torch")

from repro_torch.configs import (ALL_ARCHS, ASSIGNED_ARCHS,  # noqa: E402
                                 SHAPES, get_config, get_shape,
                                 shape_applicable)
from repro_torch.models.params import count_params  # noqa: E402

EXPECTED = {
    # arch: (total params ±tol, active ±tol) in billions; None = sanity only
    "gemma2-2b": (2.61, None),
    "olmo-1b": (1.18, None),
    "glm4-9b": (9.40, None),
    "qwen2.5-3b": (3.09, None),
    "paligemma-3b": (2.51, None),        # LM backbone only (vision stubbed)
    "deepseek-v3-671b": (671.0, 37.55),
    "mamba2-1.3b": (1.34, None),
    "jamba-1.5-large-398b": (397.7, None),
    "whisper-small": (0.24, None),
    "mixtral-8x7b": (46.7, 12.9),
}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_loads(arch):
    cfg = get_config(arch)
    assert cfg.name == arch
    assert cfg.num_layers > 0 and cfg.d_model > 0 and cfg.vocab_size > 0
    assert cfg.num_periods * len(cfg.period) + len(cfg.prologue) \
        == cfg.num_layers


@pytest.mark.parametrize("arch", list(EXPECTED))
def test_param_counts(arch):
    total, active = EXPECTED[arch]
    n = count_params(get_config(arch)) / 1e9
    assert abs(n - total) / total < 0.02, f"{arch}: {n:.2f}B vs {total}B"
    if active:
        na = count_params(get_config(arch), active_only=True) / 1e9
        assert abs(na - active) / active < 0.03


def test_assigned_archs_complete():
    assert len(ASSIGNED_ARCHS) == 10
    assert len(SHAPES) == 4
    assert set(ASSIGNED_ARCHS) | {"mixtral-8x7b"} == set(ALL_ARCHS)


def test_shape_applicability():
    # long_500k only for the sub-quadratic stacks
    runs = {a for a in ALL_ARCHS
            if shape_applicable(get_config(a), get_shape("long_500k"))[0]}
    assert runs == {"mamba2-1.3b", "jamba-1.5-large-398b"}
    for a in ALL_ARCHS:
        for s in ("train_4k", "prefill_32k", "decode_32k"):
            assert shape_applicable(get_config(a), get_shape(s))[0]


def test_smoke_configs_reduced():
    for a in ALL_ARCHS:
        cfg, sm = get_config(a), get_config(a).smoke()
        assert sm.num_layers <= cfg.num_layers
        assert sm.d_model < cfg.d_model
        assert count_params(sm) < count_params(cfg)
        assert len(sm.period) == len(cfg.period)   # same family structure


def test_registry_matches_reference():
    from repro import configs as jconfigs
    assert ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert set(ALL_ARCHS) == set(jconfigs.ALL_ARCHS)
    for name, shape in SHAPES.items():
        js = jconfigs.get_shape(name)
        assert (shape.seq_len, shape.global_batch, shape.mode) == \
            (js.seq_len, js.global_batch, js.mode)
        sm, jsm = get_shape(name).smoke(), js.smoke()
        assert (sm.seq_len, sm.global_batch) == (jsm.seq_len,
                                                 jsm.global_batch)
        for a in ALL_ARCHS:
            assert shape_applicable(get_config(a), shape) == \
                jconfigs.shape_applicable(jconfigs.get_config(a), js)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_count_params_equals_reference(arch):
    from repro.configs import get_config as jget
    from repro.models.params import count_params as jcount
    for smoke in (False, True):
        tc, jc = get_config(arch), jget(arch)
        if smoke:
            tc, jc = tc.smoke(), jc.smoke()
        for kw in ({}, {"active_only": True}, {"include_embed": False}):
            assert count_params(tc, **kw) == jcount(jc, **kw), (smoke, kw)
