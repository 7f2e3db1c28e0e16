"""The port's data pipeline, checkpoints and trainer, against the JAX
package on the CPU.

  * ``DataPipeline`` batches equal rows drawn in order from the
    reference's ``pack_documents(SyntheticCorpus(cfg).documents(), ...)``
    (its numpy streams), with targets the shifted tokens.
  * After ``skip(n)`` the port's pipeline gives batch n + 1 of the
    sequential stream, where the reference's producer thread, started in
    its constructor, races ``skip`` for the same generator; ``skip`` once
    the stream has started raises.  A consumer slower than the
    producer's put timeout still reads the sequential stream.
  * ``CheckpointManager``: round trip, ``keep`` GC, no ``.tmp`` left, a
    given step, bf16 leaves as their bits; an async snapshot is a copy
    that a later in-place update does not reach.
  * Checkpoints cross between the packages bit for bit, bf16 included: a
    JAX-written one restores in the port, a port-written one in
    ``repro.runtime.checkpoint.CheckpointManager``.
  * ``Trainer`` lowers the loss on olmo-1b and mixtral ``.smoke()``
    (``test_system.py``'s two training tests), and a run killed after
    step 4 and resumed to step 6 ends with parameters, moments and loss
    bit-equal to an uninterrupted 6-step run, in float32.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, DataPipeline  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.training.optimizer import tree_leaves  # noqa: E402
from repro_torch.training.trainer import Trainer, TrainConfig  # noqa: E402

DATA = dict(vocab_size=128, seq_len=32, batch_size=4, seed=7)


def _sequential_rows(n_rows, **kw):
    """The reference's packed rows, drawn in order from its corpus."""
    from repro.data import pipeline as jpipe
    c = jpipe.DataConfig(**{**DATA, **kw})
    rows = jpipe.pack_documents(jpipe.SyntheticCorpus(c).documents(),
                                c.seq_len)
    return np.stack([next(rows) for _ in range(n_rows)])


# ----------------------------------------------------------------- data

@pytest.mark.parametrize("kw", [{}, {"host_id": 1, "num_hosts": 2},
                                {"seq_len": 17, "batch_size": 3}])
def test_pipeline_equals_reference_stream(kw):
    c = DataConfig(**{**DATA, **kw})
    p = DataPipeline(c)
    rows = _sequential_rows(5 * c.batch_size, **kw)
    for i in range(5):
        b = next(p)
        want = rows[i * c.batch_size:(i + 1) * c.batch_size]
        np.testing.assert_array_equal(b["tokens"], want[:, :-1])
        np.testing.assert_array_equal(b["targets"], want[:, 1:])
        assert b["tokens"].dtype == np.int32
    assert p.step == 5
    p.close()


@pytest.mark.parametrize("n", [1, 3, 5])
def test_skip_gives_the_uninterrupted_stream(n):
    """Resume: skip(n) then next() is batch n + 1 of the sequential
    stream, every time (the reference's producer, started in its
    constructor, draws batches before skip runs)."""
    B = DATA["batch_size"]
    want = _sequential_rows((n + 2) * B)
    for _ in range(5):
        p = DataPipeline(DataConfig(**DATA))
        p.skip(n)
        assert p.step == n
        for j in (n, n + 1):
            np.testing.assert_array_equal(next(p)["tokens"],
                                          want[j * B:(j + 1) * B, :-1])
        assert p.step == n + 2
        p.close()


@pytest.mark.parametrize("n", [0, 2])
def test_slow_consumer_gets_the_sequential_stream(n):
    """A consumer slower than the producer's 0.5 s put timeout (a step at
    full width is) still reads the sequential stream, from the start and
    after skip(n): the producer offers the batch it built until it is
    taken (the reference's drops it and builds the next)."""
    import time
    B = DATA["batch_size"]
    want = _sequential_rows((n + 4) * B)
    p = DataPipeline(DataConfig(**DATA), prefetch=1)
    p.skip(n)
    for j in range(n, n + 4):
        np.testing.assert_array_equal(next(p)["tokens"],
                                      want[j * B:(j + 1) * B, :-1])
        if j < n + 2:
            time.sleep(1.2)
    p.close()


def test_skip_after_start_raises():
    p = DataPipeline(DataConfig(**DATA))
    next(p)
    with pytest.raises(RuntimeError, match="started"):
        p.skip(1)
    p.close()


# ----------------------------------------------------------- checkpoints

def _tree(x=0.0):
    return {"a": torch.full((3, 4), 1.0 + x),
            "b": {"c": torch.arange(5) + int(x),
                  "h": torch.linspace(-3, 3, 6).to(torch.bfloat16) + x},
            "step": torch.tensor(7, dtype=torch.int32)}


def _assert_tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_checkpoint_round_trip(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(10, _tree(), extra={"data_step": 10})
    step, tree, extra = cm.restore()
    assert step == 10 and extra["data_step"] == 10
    _assert_tree_equal(tree, _tree())
    assert tree["step"].dim() == 0
    assert not list(tmp_path.glob("*.tmp"))
    man = json.loads((tmp_path / "step_00000010" / "manifest.json")
                     .read_text())
    dt = {tuple(x["path"]): x["dtype"] for x in man["leaves"]}
    assert dt[("b", "h")] == "bfloat16" and dt[("a",)] == "float32"
    raw = np.load(tmp_path / "step_00000010" / "b__h.npy")
    assert raw.dtype == np.uint16         # bf16 as its bits


def test_checkpoint_keep_and_given_step(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        cm.save_async(s, _tree(s))
    cm.wait()
    assert cm.all_steps() == [3, 4]
    step, tree, _ = cm.restore()
    assert step == 4
    _assert_tree_equal(tree, _tree(4.0))
    step, tree, _ = cm.restore(step=3)
    assert step == 3
    _assert_tree_equal(tree, _tree(3.0))
    assert not list(tmp_path.glob("*.tmp"))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore()


def test_async_snapshot_is_a_copy(tmp_path):
    """The snapshot is taken at save_async: an in-place update right after
    (as apply_updates makes) does not reach what the thread writes."""
    cm = CheckpointManager(tmp_path)
    tree = {"w": torch.zeros(1 << 20), "h": torch.zeros(8,
                                                        dtype=torch.bfloat16)}
    cm.save_async(1, tree)
    with torch.no_grad():
        tree["w"].add_(1.0)
        tree["h"].add_(1.0)
    cm.wait()
    _, got, _ = cm.restore()
    assert not got["w"].any() and not got["h"].any()


def test_checkpoints_cross_between_packages(tmp_path):
    """A JAX-written checkpoint (bf16 via ml_dtypes) restores in the port
    bit-equal; a port-written one restores in the reference bit-equal."""
    import jax.numpy as jnp
    from repro.runtime.checkpoint import CheckpointManager as JaxCM
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1, (4, 6)).astype(np.float32)
    jtree = {"w": jnp.asarray(w), "h": jnp.asarray(w, jnp.bfloat16),
             "n": {"i": jnp.arange(3, dtype=jnp.int32)},
             "step": jnp.int32(5)}
    JaxCM(tmp_path / "jax").save(5, jtree, extra={"data_step": 5})
    step, got, extra = CheckpointManager(tmp_path / "jax").restore()
    assert step == 5 and extra == {"data_step": 5}
    np.testing.assert_array_equal(got["w"].numpy(), w)
    assert got["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["h"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(jtree["h"]).view(np.uint16))
    assert got["n"]["i"].dtype == torch.int32 and int(got["step"]) == 5

    CheckpointManager(tmp_path / "port").save(6, got, extra={"x": 1})
    step, back, extra = JaxCM(tmp_path / "port").restore()
    assert step == 6 and extra == {"x": 1}
    for k in ("w", "h", "step"):
        a, b = np.asarray(back[k]), np.asarray(jtree[k])
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8))
    np.testing.assert_array_equal(np.asarray(back["n"]["i"]), np.arange(3))


# --------------------------------------------------------------- trainer

@pytest.mark.parametrize("arch,steps,seq_len,log_every,drop", [
    ("olmo-1b", 30, 64, 5, 0.2), ("mixtral-8x7b", 20, 48, 4, 0.1)])
def test_trainer_reduces_loss(arch, steps, seq_len, log_every, drop):
    """``test_system.py``'s two training tests, on the port."""
    t = Trainer(get_config(arch).smoke(),
                TrainConfig(steps=steps, batch_size=4, seq_len=seq_len,
                            log_every=log_every), device="cpu")
    t.run()
    losses = [m["loss"] for m in t.metrics_log]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - drop, losses
    assert t.step == steps


def test_trainer_kill_and_resume_is_bit_equal(tmp_path):
    cfg = dataclasses.replace(get_config("olmo-1b").smoke(), dtype="float32")

    def trainer(steps, ckpt):
        return Trainer(cfg, TrainConfig(steps=steps, batch_size=2,
                                        seq_len=32, ckpt_every=2,
                                        ckpt_dir=ckpt, log_every=1),
                       device="cpu")

    whole = trainer(6, None)
    whole.run()
    first = trainer(4, str(tmp_path))
    first.run()
    resumed = trainer(6, str(tmp_path))
    assert resumed.step == 4                 # resumed, not restarted
    assert resumed.data.step == 4
    resumed.run()
    assert resumed.step == 6
    assert CheckpointManager(tmp_path).all_steps() == [2, 4, 6]
    for a, b in zip(tree_leaves(whole.params), tree_leaves(resumed.params)):
        assert torch.equal(a, b)
    for name in ("mu", "nu", "step"):
        for a, b in zip(tree_leaves(whole.opt_state[name]),
                        tree_leaves(resumed.opt_state[name])):
            assert torch.equal(a, b)
    assert whole.metrics_log[-1] == resumed.metrics_log[-1]
