"""The port's examples (``repro_torch/examples/quickstart.py``,
``serve_continuous_batching.py``, ``finetune_layer_sensitivity.py``) and
``train/paper_tables.py::fig1_throughput``, run with ``--device cpu`` at
tiny sizes.

Stated tolerances:

* quickstart: finite losses for fp32, int16 and int8 from one init; the
  first int16 loss within 1e-3 of fp32's (the same weights, 16-bit
  products), int8's within 1e-2.
* serving: every request gets its tokens, each in the vocabulary.
* the sensitivity sweep: its scope labels, patterns and probe paths, and
  the UNSTABLE flag of every scope under both overrides, equal the
  reference example's for the cls and img tasks (no tolerance: strings
  and booleans); both axes run end to end, and each scope's policy JSON
  reads back to the policy the sweep ran.
* ``fig1_throughput``: the H100's data-sheet peaks in the reference's row
  format, every product run (no time claimed on the CPU).
* Without a card, every entry point refuses the default ``cuda``.
"""
import importlib.util
import json
import math
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.examples import serve_continuous_batching  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    finetune_layer_sensitivity as sens)
from repro_torch.train import paper_tables  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_quickstart_tracks_fp32():
    out = quickstart.main(["--steps", "2", "--batch", "2", "--seq", "16",
                           "--device", "cpu"])
    assert set(out) == {"fp32", "int16", "int8"}
    for losses in out.values():
        assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert abs(out["int16"][0] - out["fp32"][0]) <= 1e-3
    assert abs(out["int8"][0] - out["fp32"][0]) <= 1e-2


def test_serving_drains_every_request():
    got = serve_continuous_batching.main(
        ["--requests", "3", "--prompt", "5", "--new-tokens", "3",
         "--slots", "2", "--device", "cpu"])
    assert len(got) == 3
    for toks in got.values():
        assert len(toks) == 3 and all(0 <= int(t) < 512 for t in toks)


def _reference_sensitivity():
    """The reference example as a module (it imports ``benchmarks``, so
    the repository root goes on the path)."""
    pytest.importorskip("jax")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "reference_layer_sensitivity",
        os.path.join(ROOT, "examples", "finetune_layer_sensitivity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("task", ["cls", "img"])
def test_sensitivity_scopes_and_flags_match_reference(task):
    ref = _reference_sensitivity()
    from repro.core.qconfig import QuantConfig as RefConfig
    from repro.core.qpolicy import QuantPolicy as RefPolicy
    from repro.core.qpolicy import rule as ref_rule
    from repro_torch.core.qconfig import QuantConfig
    want = ref.SCOPES + ref.block_scopes(4)
    if task == "img":
        want = [("patch embed", "patch_embed", "patch_embed")] + want[1:]
    got = sens.scopes(task, 4)
    assert got == want
    assert sens.KEPT_SCOPES == ref.KEPT_SCOPES
    for paper_int8 in (False, True):
        over = ref.drop_overrides(paper_int8)
        assert sens.drop_overrides(paper_int8) == over
        for base in ("int16", "int8", "fp32"):
            for label, pattern, probe in got:
                ref_flag = ref.stability_violated(RefPolicy(
                    base=RefConfig.preset(base),
                    rules=(ref_rule(pattern, **over),)).resolve(probe))
                flag = sens.unstable(sens.scope_policy(
                    QuantConfig.preset(base), pattern, paper_int8), probe)
                assert flag == ref_flag, (base, paper_int8, label)


def test_sensitivity_sweep_runs_both_axes(tmp_path):
    from repro_torch.core.qpolicy import QuantPolicy
    args = ["--steps", "1", "--batch", "4", "--eval-n", "8",
            "--device", "cpu"]
    out_file = tmp_path / "policies.json"
    out = sens.main(args + ["--blocks", "1", "--policy-out", str(out_file)])
    assert set(out["baselines"]) == {"fp32", "int16", "int8"}
    scopes = sens.scopes("cls", 1)
    assert [r[0] for r in out["scopes"]] == [s[0] for s in scopes]
    # the naive w8-a8-g8 drop violates the w8 => act >= 12 constraint
    assert all(r[3] for r in out["scopes"])
    assert all(0 <= r[2] <= 100 for r in out["scopes"])
    written = json.loads(out_file.read_text())
    for row, (label, pattern, probe) in zip(written, scopes):
        assert row["scope"] == label
        want = sens.scope_policy(sens.QuantConfig.preset("int16"), pattern,
                                 False)
        assert QuantPolicy.from_json(row["policy"]) == want
    kept = sens.main(args + ["--kept-ops"])
    assert set(kept) == {"fp32", "integer"} | {
        label for label, _ in sens.KEPT_SCOPES}


def test_fig1_throughput_rows_on_the_cpu():
    rows = paper_tables.fig1_throughput(device="cpu", sizes=(64,))
    assert [r[0] for r in rows[:3]] == [
        "fig1_model/h100_int8", "fig1_model/h100_bf16", "fig1_model/h100_f32"]
    assert rows[0][2].startswith("peak=1979e12ops")
    assert rows[1][2].startswith("peak=989e12ops")
    assert rows[2][2].startswith("peak=67e12ops")
    assert [r[0] for r in rows[3:]] == [
        "fig1_cpu/bfp_matmul_int8", "fig1_cpu/f32_matmul",
        "fig1_cpu/bf16_matmul"]
    assert all(r[1] == 0.0 for r in rows)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("entry", ["quickstart", "serve", "sensitivity",
                                   "fig1"])
def test_entry_points_refuse_cuda_without_a_card(entry):
    calls = {"quickstart": lambda: quickstart.main(["--steps", "1"]),
             "serve": lambda: serve_continuous_batching.main([]),
             "sensitivity": lambda: sens.main(["--steps", "1"]),
             "fig1": lambda: paper_tables.fig1_throughput()}
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
