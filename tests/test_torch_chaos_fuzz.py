"""The chaos fuzz of ``tests/test_chaos.py`` on the port, against the JAX
engine under the same schedule: its two fuzz modes (``kv_paged`` and
``expert_module_kv``) at the fixed seeds 2..7 of its seeded sweep (no
hypothesis, so the count is steady), each schedule held as
``tests/test_torch_chaos.py`` holds its cases — transcripts equal to the
JAX engine's and to the port's fault-free run, the whole
``fault_traffic()``, ``kv_traffic()``, ``weight_traffic()`` and the plan's
per-site op counts equal, with the runtime modules' clocks frozen.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_chaos import (FUZZ_MODES, _check_chaos,  # noqa: E402,F401
                              frozen_clock, setup)


@pytest.mark.parametrize("seed", range(2, 8))
@pytest.mark.parametrize("mode", FUZZ_MODES)
def test_chaos_fuzz_matches_jax(setup, mode, seed):  # noqa: F811
    _check_chaos(setup, mode, seed, work_seed=1 + seed % 3)
