"""Port parity of the bit-width sweep on the SQuAD-proxy span task: the
reduced BERT of ``test_torch_sweep_cls.py`` with the span head, two AdamW
steps under int16, int12, int10 and fp32 from the reference's weights,
against the JAX loop on the pallas backend with round-to-nearest
gradients: step 0's loss within 1e-6 relative, step 1's within 1e-4;
``evaluate``'s exact match equals the reference harness's (at int16 and
fp32)."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_sweep_cls import sweep_parity  # noqa: E402


@pytest.mark.parametrize("preset", ["int16", "int12", "int10", "fp32"])
def test_span_sweep_matches_reference(preset):
    losses, ref, metric, ref_metric = sweep_parity("span", preset)
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses[0], ref[0], rtol=1e-6)
    np.testing.assert_allclose(losses[1], ref[1], rtol=1e-4)
    assert metric == ref_metric
