"""The port's token sampling against the JAX package's.

  * Temperature 0 (or below) is the greedy argmax, whatever the generator.
  * At T > 0, the empirical frequencies of 20 000 draws from one seeded
    logits row, by the port (its generator) and by JAX (its key), are each
    within ``FREQ_TOL`` of ``softmax(logits / T)``: the draws cannot be
    equal (JAX splits keys), their distribution is.
  * ``top_k`` keeps exactly the logits JAX's mask keeps (ties at the cut
    included): both packages draw every kept token and no other, with the
    kept tokens' renormalized frequencies.
  * The engine at T > 0 reproduces its transcripts from ``seed`` and
    changes them with it, in continuous and static mode; at T = 0 the seed
    does not matter.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serving.sampling import sample as jax_sample  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.sampling import sample  # noqa: E402

DRAWS = 20_000
# a frequency's standard error at 20 000 draws is at most 0.0035: the bound
# is over 4 of them
FREQ_TOL = 0.015


def _logits(seed, V=16, scale=1.5):
    return np.random.default_rng(seed).normal(scale=scale, size=(V,)) \
        .astype(np.float32)


def _softmax(x):
    e = np.exp(x - x.max())
    return e / e.sum()


def _freqs(tokens, V):
    return np.bincount(np.asarray(tokens), minlength=V) / len(tokens)


def _draw_both(row, temperature, top_k=0, seed=0):
    rows = np.broadcast_to(row, (DRAWS, row.shape[0])).copy()
    g = torch.Generator().manual_seed(seed)
    port = sample(torch.from_numpy(rows), g, temperature=temperature,
                  top_k=top_k)
    assert port.dtype == torch.int32 and port.shape == (DRAWS,)
    ref = jax_sample(jnp.asarray(rows), jax.random.key(seed),
                     temperature=temperature, top_k=top_k)
    V = row.shape[0]
    return _freqs(port.numpy(), V), _freqs(np.asarray(ref), V)


def test_temperature_zero_is_argmax():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(7, 50)).astype(np.float32))
    want = torch.argmax(logits, -1).to(torch.int32)
    for t in (0.0, -1.0):
        assert torch.equal(sample(logits, temperature=t), want)
        assert torch.equal(sample(logits, torch.Generator(), temperature=t),
                           want)
    np.testing.assert_array_equal(
        want.numpy(), np.asarray(jax_sample(jnp.asarray(logits.numpy()),
                                            jax.random.key(0))))
    with pytest.raises(ValueError):
        sample(logits, None, temperature=0.8)


@pytest.mark.parametrize("temperature", [0.5, 0.8, 1.0, 2.0])
@pytest.mark.parametrize("seed", [1, 2])
def test_frequencies_match_softmax(temperature, seed):
    row = _logits(seed)
    want = _softmax(row / temperature)
    port, ref = _draw_both(row, temperature, seed=seed)
    assert np.abs(port - want).max() < FREQ_TOL
    assert np.abs(ref - want).max() < FREQ_TOL


@pytest.mark.parametrize("top_k", [1, 3, 8])
def test_top_k_keeps_what_jax_keeps(top_k):
    """A row with ties at the cut: the mask keeps every logit at least the
    k-th largest, in both packages."""
    row = np.array([0.1, 2.0, 1.2, 1.2, -0.5, 1.2, 0.7, 2.0, 0.3, -1.0,
                    0.9, 1.5], np.float32)
    temperature = 0.9
    scaled = row / temperature
    cut = np.sort(scaled)[::-1][top_k - 1]
    kept = scaled >= cut
    want = np.where(kept, _softmax(np.where(kept, scaled, -np.inf)), 0.0)
    port, ref = _draw_both(row, temperature, top_k=top_k, seed=top_k)
    np.testing.assert_array_equal(port > 0, kept)
    np.testing.assert_array_equal(ref > 0, kept)
    assert np.abs(port - want).max() < FREQ_TOL
    assert np.abs(ref - want).max() < FREQ_TOL


@pytest.fixture(scope="module")
def smoke():
    cfg = dataclasses.replace(get_config("mixtral-8x7b").smoke(),
                              dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, cfg.vocab_size, n) for n in (5, 12, 3, 20)]
    return cfg, params, prompts


def _serve(smoke, **kw):
    cfg, params, prompts = smoke
    eng = Engine(cfg, params, EngineConfig(ubatch=2, num_ubs=2, max_seq=64,
                                           decode_chunk=4, **kw),
                 device="cpu")
    rids = [eng.submit(p, 10) for p in prompts]
    out = eng.run_until_idle()
    return [out[r] for r in rids]


@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_engine_reproduces_from_seed(smoke, mode):
    a = _serve(smoke, mode=mode, temperature=0.8, seed=0)
    b = _serve(smoke, mode=mode, temperature=0.8, seed=0)
    c = _serve(smoke, mode=mode, temperature=0.8, seed=1)
    assert a == b
    assert a != c
    assert all(len(t) == 10 for t in a + c)
    greedy = [_serve(smoke, mode=mode, seed=s) for s in (0, 1)]
    assert greedy[0] == greedy[1] != a
