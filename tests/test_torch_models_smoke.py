"""``tests/test_models_smoke.py`` mirrored on the port: for every arch at
the reference's reduced ``.smoke()`` config (its dtype, bfloat16 for
most), one train forward (logit shapes, no NaN, the gemma2 logit cap),
one train step of ``make_train_step`` (finite loss and grad norm, the
step counter at 1, parameters moved) and one decode step against a live
cache after a prefill (shapes, no NaN, ``pos`` advanced).  Port-only
assertions: the JAX package is not run here (``test_torch_train*.py``
holds the two against each other)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import ALL_ARCHS, get_config, get_shape  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models.common import torch_dtype  # noqa: E402
from repro_torch.models.inputs import concrete_inputs  # noqa: E402
from repro_torch.models.model import forward, unembed  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.training.optimizer import (OptConfig,  # noqa: E402
                                            init_opt_state, tree_leaves)
from repro_torch.training.train_step import (make_train_step,  # noqa: E402
                                             requires_grad_)

pytestmark = pytest.mark.slow      # all-arch sweep, as the reference's


def _params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _batch(cfg):
    return concrete_inputs(cfg, get_shape("train_4k").smoke(), device="cpu")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_forward(arch):
    cfg = get_config(arch).smoke()
    params = _params(cfg)
    batch = _batch(cfg)
    extras = {k: v for k, v in batch.items() if k in ("frames", "patches")}
    with torch.no_grad():
        out = forward(cfg, params, batch["tokens"], mode="train", **extras)
        logits = unembed(cfg, params, out["hidden"])
    assert logits.shape == (*batch["tokens"].shape, cfg.vocab_size)
    assert not bool(torch.isnan(logits).any())
    if cfg.logit_softcap:
        assert float(logits.abs().max()) <= cfg.logit_softcap + 1e-3


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_train_step(arch):
    cfg = get_config(arch).smoke()
    params = requires_grad_(_params(cfg))
    before = [p.detach().clone() for p in tree_leaves(params)]
    opt = OptConfig(warmup_steps=2)
    opt_state = init_opt_state(params, opt)
    step = make_train_step(cfg, opt)
    new_params, new_state, metrics = step(params, opt_state, _batch(cfg))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert int(new_state["step"]) == 1
    moved = [float((a.detach().float() - b.float()).abs().max())
             for a, b in zip(tree_leaves(new_params), before)]
    assert max(moved) > 0


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_decode_step(arch):
    """decode shapes: one new token against a live cache."""
    cfg = get_config(arch).smoke()
    params = _params(cfg)
    B, S = 2, 16
    cache = kvcache.init_cache(cfg, B, 32, device="cpu")
    toks = torch.ones((B, S), dtype=torch.int32)
    extras = {}
    dt = torch_dtype(cfg.dtype)
    if cfg.encoder_layers:
        extras["frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model),
                                       dtype=dt)
    if cfg.vision_tokens:
        extras["patches"] = torch.zeros((B, cfg.vision_tokens, cfg.d_model),
                                        dtype=dt)
    with torch.no_grad():
        out = forward(cfg, params, toks, cache=cache, mode="prefill",
                      **extras)
        cache = out["cache"]
        out = forward(cfg, params, toks[:, :1], cache=cache, mode="decode")
        logits = unembed(cfg, params, out["hidden"][:, -1])
    assert logits.shape == (B, cfg.vocab_size)
    assert not bool(torch.isnan(logits).any())
    assert int(out["cache"]["pos"][0]) == S + 1
