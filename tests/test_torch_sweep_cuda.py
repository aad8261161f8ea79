"""The sweep's claims on the card (``cuda``-marked; they skip without a
CUDA device): each kernel wrapper's launches per training step are the
same at int16, int12, int10 and int8 for bert-tiny (cls, span) and
vit-tiny (img), FP32 launches none; ``Engine.generate`` on the card gives
the CPU's greedy tokens on a reduced smollm-135m under FP32 and int8."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.train import finetune as tf  # noqa: E402


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the chip)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["cls", "span", "img"])
def test_step_stats_launches_equal_across_integer_presets(dev, task):
    ft = tf.FtConfig(batch=4)
    stats = {p: tf.step_stats(task, QuantConfig.preset(p), ft, repeats=1,
                              device=dev)
             for p in ("fp32", "int16", "int12", "int10", "int8")}
    assert stats["fp32"]["launches"] == 0
    ref = stats["int8"]["by_kernel"]
    for name in ("dfx_quantize", "bfp_matmul", "bfp_matmul_nt",
                 "bfp_matmul_tn", "int_layernorm_fwd", "int_layernorm_bwd",
                 "int_attn_fwd", "int_attn_bwd_dq", "int_attn_bwd_dkv"):
        assert ref[name] > 0, name
    for p in ("int16", "int12", "int10"):
        assert stats[p]["by_kernel"] == ref, p
        assert stats[p]["launches"] == stats["int8"]["launches"]
        assert stats[p]["step_us"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["fp32", "int8"])
def test_generate_on_the_card_matches_the_cpu(dev, preset):
    cfg = registry.get_config("smollm-135m").reduced()
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32)
    scfg = ServeConfig(max_seq=32, batch_slots=2)
    q = QuantConfig.preset(preset)
    cpu = Engine(params, cfg, q, scfg, device="cpu")
    card = Engine(_to(params, dev), cfg, q, scfg, device=dev)
    np.testing.assert_array_equal(card.generate(prompts, 6),
                                  cpu.generate(prompts, 6))


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
