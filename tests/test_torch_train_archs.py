"""A whole train step of the port against the JAX package's
``make_train_step`` in float32 on the CPU, for the families whose
training path differs from mixtral's and olmo's (``test_torch_train.py``
holds those and the step's parts):

  * deepseek-v3 — MLA attention (D 192 / Dv 128 through
    ``flash_prefill``), the dense prologue layers, sigmoid routing with
    shared experts;
  * paligemma-3b — the patch prefix (``batch["patches"]``) and the loss
    mask over it;
  * whisper-small — the encoder over ``batch["frames"]`` and the
    decoder's cross-attention.

The limits are ``test_torch_train.py``'s: loss, lm_loss, aux_loss and
grad_norm within 1e-5 relative, every gradient leaf within 1e-4 of its
max-abs, the updated parameters within 1e-6 of each leaf's max-abs where
the gradient element is above the gradients' tolerance.
"""
import pytest

pytest.importorskip("torch")

from test_torch_train import (assert_step_matches,  # noqa: E402
                              jax_step_outputs, port_step_outputs)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "paligemma-3b",
                                  "whisper-small"])
def test_train_step_matches_reference(arch):
    ref_out = jax_step_outputs(arch)
    got = port_step_outputs(ref_out)
    if arch == "deepseek-v3-671b":
        assert ref_out["metrics"]["aux_loss"] > 0
    assert set(ref_out["batch"]) >= {"tokens", "targets"}
    assert_step_matches(ref_out, got)
