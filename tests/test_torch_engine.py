"""The port's continuous-batching Engine against the JAX Engine.

Same weights (through numpy), same six prompts of mixed lengths and quotas
plus one whose prompt and quota overrun the ring (aborted at submit), 2
groups x 2 slots so that slots are reused: the greedy transcripts must be
equal and every slot must end FREE with the same history in both packages.
The JAX engine runs with its watchdog and degradation ladder off, so its
behaviour does not depend on wall-clock time; it is built once per module.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models.model import ExecPolicy as JaxPolicy  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving.scheduler import SlotState as JaxSlotState  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import ExecPolicy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.scheduler import SlotState  # noqa: E402

LENS = (5, 14, 3, 60, 9, 20, 7)
QUOTAS = (6, 3, 9, 9, 5, 7, 4)
TOO_LONG = 3                      # 60 + 9 tokens > max_seq 64
SLOTS = dict(ubatch=2, num_ubs=2, max_seq=64, decode_chunk=4)


@pytest.fixture(scope="module")
def jax_run():
    cfg = dataclasses.replace(get_config("mixtral-8x7b").smoke(),
                              dtype="float32")
    params = init_params(cfg, jax.random.key(1))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, n) for n in LENS]
    eng = JaxEngine(cfg, params,
                    JaxEngineConfig(**SLOTS, watchdog=False, degrade=False),
                    JaxPolicy(moe_impl="grouped", use_kernels=False))
    rids = [eng.submit(p, q) for p, q in zip(prompts, QUOTAS)]
    out = eng.run_until_idle()
    slots = [s for grp in eng.scheduler.slots for s in grp]
    assert all(s.state is JaxSlotState.FREE for s in slots)
    return dict(params=jax.tree.map(np.asarray, params), prompts=prompts,
                rids=rids, out=out, histories=[s.history for s in slots],
                tokens_out=eng.tokens_out,
                aborted=[eng.scheduler.requests[r].aborted for r in rids])


@pytest.mark.parametrize("use_kernels", [True, False])
def test_engine_greedy_transcripts_match_jax(jax_run, use_kernels):
    cfg = dataclasses.replace(t_get_config("mixtral-8x7b").smoke(),
                              dtype="float32")
    eng = Engine(cfg, params_from_numpy(jax_run["params"], device="cpu"),
                 EngineConfig(**SLOTS),
                 ExecPolicy(moe_impl="grouped", use_kernels=use_kernels),
                 device="cpu")
    rids = [eng.submit(p, q) for p, q in zip(jax_run["prompts"], QUOTAS)]
    out = eng.run_until_idle()
    assert rids == jax_run["rids"]
    assert out == jax_run["out"]
    aborted = [eng.scheduler.requests[r].aborted for r in rids]
    assert aborted == jax_run["aborted"]
    assert aborted == [i == TOO_LONG for i in range(len(rids))]
    assert [len(out[r]) for r in rids] == [
        0 if a else q for a, q in zip(aborted, QUOTAS)]
    assert eng.tokens_out == jax_run["tokens_out"]
    slots = [s for grp in eng.scheduler.slots for s in grp]
    assert all(s.state is SlotState.FREE for s in slots)
    assert [s.history for s in slots] == jax_run["histories"]
    assert max(len(h) for h in jax_run["histories"]) > 1   # slots reused
