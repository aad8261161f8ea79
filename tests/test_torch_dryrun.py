"""The dry-run (``repro_torch/launch/dryrun.py``): one rank's step of each
(arch x shape) cell on the ``meta`` device, over a dry mesh
(``sharding.dry_mesh``), against the reference's ``repro/launch/
dryrun.py`` and against real runs of the same steps on the CPU.

* ``SHAPES``, ``shape_applicable``, ``VARIANTS`` and ``quant_ids()`` are
  the reference's; ``input_specs`` gives the reference's shapes and dtypes
  (``jax.eval_shape``, no compile) for every arch x applicable shape at
  full size.
* One rank: the argument bytes of reduced qwen1.5-0.5b's train, prefill
  and decode cells and reduced whisper-large-v3's train cell equal the
  summed bytes of the reference's ``build_cell`` arguments less its 8-byte
  PRNG key (the port's generator is not a tensor).
* The meta step calls each kernel wrapper as often as the same step runs
  its plain version on the CPU (the one-device step of ``launch.train``,
  against the dry-run's one-rank mesh).
* (data 2, model 2): the dry mesh's ``sharding.STATS`` of reduced qwen's
  train cell, sequence-sharded and ``no_sp``, equal rank 0's of a real
  4-rank gloo world (``tests/torch_dist_worker.py``, case
  ``dry_stats``), tag for tag.
* Variants: ``remat_dots`` leaves an int8 cell's memory as ``baseline``'s;
  ``q_gather`` moves each per-layer gather as int8 planes, a quarter of
  the FP32 bytes, plus the exponents.
* The CLI at full size on the 16 x 16 dry mesh (qwen1.5-0.5b): train_4k
  ok, its argument bytes the rank's ``param_pspecs`` blocks, their FP32
  moments, the step counter and the batch rows; prefill / decode
  ``not_ported``; long_500k ``skipped``; ``--resume`` and
  ``--analysis-only``.
"""
import dataclasses
import json
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch import sharding  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import (_lib, bfp_matmul, dfx_quant,  # noqa: E402
                                 int_attention, int_norm)
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import SHAPES, shape_applicable  # noqa: E402
from repro_torch.train import optimizer as opt_lib, trainer  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once, and
    small ops on many threads oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = list(registry.ARCH_IDS)
INT8 = registry.get_quant("int8")
ONE = sharding.dry_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def ref():
    """The reference's dry-run module.  It sets ``XLA_FLAGS`` for 512 host
    devices at import: the backend is up before it (so this process keeps
    its devices) and the variable is put back after."""
    jax.devices()
    prev = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref_dryrun
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return ref_dryrun


def test_grid_variants_and_presets_are_the_reference(ref):
    from repro.configs import registry as rreg
    from repro.models import config as rconfig
    assert SHAPES == rconfig.SHAPES
    assert dryrun.VARIANTS == ref.VARIANTS
    assert tuple(registry.quant_ids()) == tuple(rreg.quant_ids())
    for arch in ARCHS:
        for shape in SHAPES:
            assert shape_applicable(registry.get_config(arch), shape) == \
                rconfig.shape_applicable(rreg.get_config(arch), shape)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}


def test_input_specs_are_the_reference(ref):
    from repro.configs import registry as rreg
    n = 0
    for arch in ARCHS:
        for shape in SHAPES:
            if not shape_applicable(registry.get_config(arch), shape)[0]:
                continue
            got = _flat(registry.input_specs(registry.get_config(arch),
                                             shape))
            want = _flat(rreg.input_specs(rreg.get_config(arch), shape))
            assert sorted(got) == sorted(want), (arch, shape)
            for k, t in got.items():
                assert t.device.type == "meta", (arch, shape, k)
                assert tuple(t.shape) == tuple(want[k].shape), (arch, shape, k)
                assert str(t.dtype).split(".")[-1] == str(want[k].dtype), (
                    arch, shape, k)
                n += 1
    assert n > 80


def _ref_argument_bytes(ref, arch, shape):
    from repro.configs import registry as rreg
    from repro.core.qconfig import QuantConfig
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    cfg = rreg.get_config(arch).reduced()
    args = ref.build_cell(arch, shape, mesh, dataclasses.replace(
        QuantConfig.int8(), backend="pallas"), cfg=cfg)[1]
    return sum(math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
               for leaf in jax.tree.leaves(args))


@pytest.mark.parametrize("arch,shape", [
    ("qwen1.5-0.5b", "train_4k"), ("qwen1.5-0.5b", "prefill_32k"),
    ("qwen1.5-0.5b", "decode_32k"), ("whisper-large-v3", "train_4k")])
def test_one_rank_argument_bytes_are_the_reference(ref, arch, shape):
    rec = dryrun.run_cell(arch, shape, ONE, "1x1", INT8, None,
                          cfg=registry.get_config(arch).reduced())
    assert rec["status"] == "ok", rec.get("traceback")
    key = 8 if SHAPES[shape][2] == "train" else 0      # the PRNG key
    assert rec["memory"]["argument_bytes_per_device"] == \
        _ref_argument_bytes(ref, arch, shape) - key
    assert rec["memory"]["temp_bytes_per_device"] > 0
    assert rec["cost"]["flops"] > 0 and rec["launches"]
    if SHAPES[shape][2] == "train":
        # AdamW updates the parameters and moments in place: all but the
        # step counter and the batch
        specs = registry.input_specs(registry.get_config(arch).reduced(),
                                     shape)
        batch = sum(t.numel() * t.element_size() for t in specs.values())
        mem = rec["memory"]
        assert mem["alias_bytes_per_device"] == \
            mem["argument_bytes_per_device"] - 4 - batch


def _wrapper_case(name: str, dev: str):
    """(args, kwargs, product flops) of one call of kernel wrapper
    ``name`` at small shapes on ``dev``."""
    g = torch.Generator().manual_seed(0)

    def i8(*shape):
        return torch.randint(-100, 100, shape, dtype=torch.int8,
                             generator=g).to(dev)

    def f32(*shape):
        return torch.rand(shape, generator=g).to(dev)

    def e(*shape):
        return torch.full(shape, -7, dtype=torch.int32, device=dev)
    M, K, N, E = 24, 40, 16, 3
    B, Sq, Sk, KV, G, hd = 2, 8, 8, 2, 2, 16
    attn = (i8(1, B, Sq, KV, G, hd), i8(1, B, Sk, KV, hd),
            i8(2, B, Sk, KV, hd))
    off = torch.zeros(B, dtype=torch.int32, device=dev)
    kw = dict(p_bits=12, causal=True, window=None, sc=0.25)
    rows = (torch.randint(-900, 900, (M, K), dtype=torch.int16,
                          generator=g).to(dev), i8(M, K))
    lse, delta = f32(B, KV, G, Sq), f32(B, Sq, KV, G)
    hk = B * KV * G * Sq * Sk * hd
    return {
        "dfx_quantize": ((f32(M, K), e()), dict(bits=12, limb_planes=True),
                         0),
        "dfx_quantize_grouped": ((f32(E, M, K), e(E)), dict(bits=8), 0),
        "bfp_matmul": ((i8(2, M, K), i8(1, K, N), e()), {}, 2 * M * K * N),
        "bfp_matmul_nt": ((i8(1, M, N), i8(2, K, N), e()), {},
                          2 * M * K * N),
        "bfp_matmul_tn": ((i8(2, M, K), i8(1, M, N), e()), {},
                          2 * M * K * N),
        "bfp_matmul_batched": ((i8(1, E, M, K), i8(1, E, K, N), e(E)), {},
                               2 * E * M * K * N),
        "bfp_matmul_batched_nt": ((i8(1, E, M, N), i8(1, E, K, N), e(E)),
                                  {}, 2 * E * M * K * N),
        "bfp_matmul_batched_tn": ((i8(1, E, M, K), i8(1, E, M, N), e(E)),
                                  {}, 2 * E * M * K * N),
        "int_rmsnorm_fwd": ((rows[0], e(), f32(K)), {}, 0),
        "int_rmsnorm_bwd": ((*rows, e(), e(), f32(K), f32(M, 1)), {}, 0),
        "int_layernorm_fwd": ((rows[0], e(), f32(K), f32(K)), {}, 0),
        "int_layernorm_bwd": ((*rows, e(), e(), f32(K), f32(M, 1),
                               f32(M, 1)), {}, 0),
        "int_attn_fwd": ((*attn, off, e(3)), kw, 4 * hk),
        "int_attn_bwd_dq": ((*attn, i8(1, B, Sq, KV, G, hd), lse, delta, off,
                             e(5)), dict(kw, ds_bits=8), 6 * hk),
        "int_attn_bwd_dkv": ((*attn, i8(1, B, Sq, KV, G, hd), lse, delta,
                              off, e(5)), dict(kw, ds_bits=8), 8 * hk),
    }[name]


@pytest.mark.parametrize("name", sorted(kops.WRAPPERS))
def test_wrapper_shape_only_path(name):
    """A meta call returns the plain version's shapes and dtypes, counts
    the call and its products' flops in ``_lib.DRY_CALLS`` / ``DRY_FLOPS``
    (never ``.launches``); a call whose operands lie on a meta and a CPU
    tensor raises."""
    wrapper = kops.WRAPPERS[name]
    args, kw, flops = _wrapper_case(name, "cpu")
    want = wrapper(*args, **kw)
    margs, mkw, _ = _wrapper_case(name, "meta")
    _lib.reset_dry()
    launches = wrapper.launches
    got = wrapper(*margs, **mkw)
    assert wrapper.launches == launches
    assert dict(_lib.DRY_CALLS) == {name: 1}
    assert _lib.DRY_FLOPS[name] == flops
    want, got = ((x,) if isinstance(x, torch.Tensor) else x
                 for x in (want, got))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.device.type == "meta"
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    if name.endswith("_fwd") and "norm" in name or "quantize" in name:
        return                    # one operand: its scalars follow it
    with pytest.raises(ValueError, match="unsupported devices"):
        wrapper(*(margs[:1] + args[1:]), **kw)


#: each wrapper's plain version, by the module that calls it
PLAINS = {"dfx_quantize": (dfx_quant, "dfx_quantize_plain"),
          "bfp_matmul": (bfp_matmul, "bfp_matmul_plain"),
          "bfp_matmul_nt": (bfp_matmul, "bfp_matmul_nt_plain"),
          "bfp_matmul_tn": (bfp_matmul, "bfp_matmul_tn_plain"),
          "int_rmsnorm_fwd": (int_norm, "int_rmsnorm_fwd_plain"),
          "int_rmsnorm_bwd": (int_norm, "int_rmsnorm_bwd_plain"),
          "int_attn_fwd": (int_attention, "int_attn_fwd_plain"),
          "int_attn_bwd_dq": (int_attention, "int_attn_bwd_dq_plain"),
          "int_attn_bwd_dkv": (int_attention, "int_attn_bwd_dkv_plain")}


def test_meta_calls_equal_the_cpu_step(monkeypatch):
    cfg = registry.get_config("qwen1.5-0.5b").reduced()
    B, S = 4, 32
    rec = dryrun.run_cell("qwen1.5-0.5b", "train_4k", ONE, "1x1", INT8, None,
                          cfg=cfg, batch=(B, S))
    assert rec["status"] == "ok", rec.get("traceback")
    calls = dict.fromkeys(PLAINS, 0)
    for name, (mod, fn) in PLAINS.items():
        plain = getattr(mod, fn)

        def counted(*a, _plain=plain, _name=name, **k):
            calls[_name] += 1
            return _plain(*a, **k)
        monkeypatch.setattr(mod, fn, counted)
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (B, S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    opt_cfg = opt_lib.OptimizerConfig()
    step = trainer.make_train_step(lm.lm_loss, cfg, INT8, opt_cfg)
    step(params, opt_lib.init(params, opt_cfg),
         {"tokens": toks, "labels": toks}, torch.Generator().manual_seed(2))
    assert all(calls.values())
    assert rec["launches"] == calls


@pytest.fixture(scope="module")
def gloo_stats(tmp_path_factory):
    toks = np.random.default_rng(0).integers(0, 512, (8, 32), np.int32)
    out = torch_dist_worker.spawn("dry_stats", 4, {"tokens": toks},
                                  str(tmp_path_factory.mktemp("dry")))
    return out[0]


@pytest.mark.parametrize("variant", ["baseline", "no_sp"])
def test_dry_mesh_stats_equal_a_gloo_world(gloo_stats, variant):
    rec = dryrun.run_cell(
        "qwen1.5-0.5b", "train_4k",
        sharding.dry_mesh((2, 2), ("data", "model")), "2x2", INT8, None,
        variant, cfg=registry.get_config("qwen1.5-0.5b").reduced(),
        batch=(8, 32))
    assert rec["status"] == "ok", rec.get("traceback")
    got = {(tag, what): v for tag, d in rec["collectives"]["by_tag"].items()
           for what, v in d.items()}
    assert got == gloo_stats[variant]
    assert ("sp_gather", "calls") in got if variant == "baseline" else \
        ("tp_out", "calls") in got


def test_remat_dots_and_q_gather():
    cfg = registry.get_config("qwen1.5-0.5b").reduced()
    mesh = sharding.dry_mesh((2, 2), ("data", "model"))
    recs = {v: dryrun.run_cell("qwen1.5-0.5b", "train_4k", mesh, "2x2", INT8,
                               None, v, cfg=cfg, batch=(8, 32), fsdp=True)
            for v in ("baseline", "remat_dots", "q_gather")}
    assert all(r["status"] == "ok" for r in recs.values())
    assert recs["remat_dots"]["memory"] == recs["baseline"]["memory"]
    assert recs["remat_dots"]["launches"] == recs["baseline"]["launches"]
    base = recs["baseline"]["collectives"]["by_tag"]
    q = recs["q_gather"]["collectives"]["by_tag"]
    f32 = base["gather_layer_f32"]
    assert "gather_layer_f32" not in q
    assert q["gather_layer_int8"]["calls"] == f32["calls"]
    assert 4 * q["gather_layer_int8"]["bytes"] == f32["bytes"]
    # one exponent of every rank along data, a stack a step
    assert q["gather_layer_exp"]["bytes"] == 4 * 2 * q["gather_layer_exp"][
        "calls"]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    dryrun.main(["--arch", "qwen1.5-0.5b", "--single-pod-only", "--outdir",
                 out])
    return os.path.join(out, "pod16x16")


def _record(d, shape):
    with open(os.path.join(d, f"qwen1.5-0.5b__{shape}.json")) as f:
        return json.load(f)


def test_cli_full_size_on_the_production_mesh(cli):
    rec = _record(cli, "train_4k")
    assert rec["status"] == "ok"
    assert set(rec) >= {"memory", "cost", "collectives", "launches",
                        "model_params", "active_params", "trace_s"}
    cfg = registry.get_config("qwen1.5-0.5b")
    mesh = sharding.dry_mesh((16, 16), ("data", "model"))
    params = lm.lm_init(torch.Generator(), cfg, device="meta")
    specs = sharding.param_pspecs(params, mesh, fsdp=False)
    blocks = sum(4 * math.prod(
        s // mesh.count(spec[i] if i < len(spec) else None)
        for i, s in enumerate(p.shape))
        for p, spec in zip(opt_lib.tree_leaves(params),
                           opt_lib.tree_leaves(specs)))
    S, B, _ = SHAPES["train_4k"]
    rows = 2 * 4 * (B // 16) * S                  # tokens and labels
    assert rec["memory"]["argument_bytes_per_device"] == \
        3 * blocks + 4 + rows                     # + m, v and the step
    assert rec["collectives"]["total"] > 0
    assert rec["collectives"]["by_tag"]["sp_gather"]["calls"] > 0
    # the serving cells: the rank's parameter blocks (FP32, no moments),
    # its rows of the prompts, and a decode cell's cache as cache_pspecs
    # lays it out
    pre, dec = _record(cli, "prefill_32k"), _record(cli, "decode_32k")
    assert pre["status"] == dec["status"] == "ok"
    S, B, _ = SHAPES["prefill_32k"]
    assert pre["memory"]["argument_bytes_per_device"] == \
        blocks + 4 * (B // 16) * S
    assert pre["collectives"]["by_tag"]["sp_gather"]["calls"] > 0
    assert dec["memory"]["argument_bytes_per_device"] == \
        blocks + _cache_bytes(cfg, "decode_32k", mesh) + 4 * (128 // 16)
    assert dec["collectives"]["by_tag"]["exponent_model"]["calls"] > 0
    assert dec["launches"]["int_attn_fwd"] == cfg.n_layers
    assert _record(cli, "long_500k")["status"] == "skipped"


def _cache_bytes(cfg, shape, mesh):
    """The rank's decode cache by ``cache_pspecs``: each leaf's block."""
    cache = registry.input_specs(cfg, shape)["cache"]
    specs = sharding.cache_pspecs(cache, mesh, cfg)
    return sum(math.prod(sharding.cache_block_shape(v.shape, specs[k], mesh))
               * v.element_size() for k, v in cache.items())


def test_kv_replicated_decode_cell_holds_one_kv_head():
    """mistral-nemo-12b's 8 kv heads over a model axis of 16: each rank
    computes with, and caches, the one kv head its query heads read."""
    cfg = registry.get_config("mistral-nemo-12b")
    mesh = sharding.dry_mesh((16, 16), ("data", "model"), rank=5)
    cache = registry.input_specs(cfg, "decode_32k")["cache"]
    specs = sharding.cache_pspecs(cache, mesh, cfg)
    assert specs["k"] == (None, "data", None, sharding.KV_HEAD, None)
    S, B, _ = SHAPES["decode_32k"]
    kv = cfg.n_layers * (B // 16) * S * cfg.head_dim * 2
    assert _cache_bytes(cfg, "decode_32k", mesh) == 2 * kv + 4 * (B // 16)
    assert sharding.kv_head_index(cfg, mesh) == 5 * (32 // 16) // (32 // 8)
    rec = dryrun.run_cell("mistral-nemo-12b", "decode_32k", mesh, "16x16",
                          INT8, None)
    assert rec["status"] == "ok", rec.get("traceback")
    params = lm.lm_init(torch.Generator(), cfg, device="meta")
    pspecs = sharding.param_pspecs(params, mesh, fsdp=registry.use_fsdp(
        "mistral-nemo-12b"))
    blocks = sum(4 * math.prod(sharding.cache_block_shape(p.shape, s, mesh))
                 for p, s in zip(opt_lib.tree_leaves(params),
                                 opt_lib.tree_leaves(pspecs)))
    assert rec["memory"]["argument_bytes_per_device"] == \
        blocks + 2 * kv + 4 * (B // 16) + 4 * (B // 16)
    # every rank projects all 8 kv heads: k / v gathered whole over model
    assert rec["collectives"]["by_tag"]["gather_layer_kv_f32"]["calls"] > 0


def test_cli_resume_and_analysis_only(cli, capsys):
    path = os.path.join(cli, "qwen1.5-0.5b__train_4k.json")
    rec = _record(cli, "train_4k")
    os.utime(path, (0, 0))
    capsys.readouterr()
    dryrun.main(["--arch", "qwen1.5-0.5b", "--single-pod-only", "--resume",
                 "--outdir", os.path.dirname(cli)])
    out = capsys.readouterr().out
    assert out.count("cached") == 4 and os.path.getmtime(path) == 0
    rec["cost"]["flops"] = 0
    with open(path, "w") as f:
        json.dump(rec, f)
    dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "train_4k",
                 "--single-pod-only", "--analysis-only", "--outdir",
                 os.path.dirname(cli)])
    assert "reanalyzed" in capsys.readouterr().out
    assert _record(cli, "train_4k")["cost"]["flops"] > 0
