"""One rank of a gloo world for the port's distributed tests.

    python tests/torch_dist_worker.py CASE RANK WORLD PORT DIR

joins the world at ``tcp://127.0.0.1:PORT``, runs ``CASE`` on the inputs
in ``DIR/in.npz`` and writes what the test holds to ``DIR/out<RANK>.pt``.
The tests spawn every rank with a timeout (``spawn``) and read the files.
No JAX here: the reference runs in a process of its own.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(case: str, world: int, inputs: dict, out_dir: str,
          timeout: float = 240.0) -> list:
    """Run ``case`` on ``world`` gloo ranks; every rank's output, in rank
    order.  The world is torn down when a rank fails or the timeout
    passes."""
    import torch
    np.savez(os.path.join(out_dir, "in.npz"), **inputs)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(r), str(world), str(port),
         out_dir], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = [""] * world
    try:
        for r, p in enumerate(procs):
            logs[r], _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"{case}: ranks {bad} failed (rc "
                             f"{[procs[r].returncode for r in bad]}):\n"
                             + logs[bad[0]][-4000:])
    return [torch.load(os.path.join(out_dir, f"out{r}.pt"),
                       weights_only=False) for r in range(world)]


def spawn_group(cases: dict, world: int, out_dir: str,
                timeout: float = 240.0) -> list:
    """Run several cases on one world of ``world`` gloo ranks, in order:
    ``cases`` maps a case to its inputs.  Every rank's ``{case: output}``,
    in rank order."""
    inputs = {f"{case}:{k}": v for case, inp in cases.items()
              for k, v in inp.items()}
    inputs["cases"] = np.array(list(cases))
    return spawn("group", world, inputs, out_dir, timeout)


# =========================================================================
# Cases (each runs on every rank; returns what the rank writes)
# =========================================================================

def case_group(inp, mesh_of):
    """The cases ``inp["cases"]`` names, in order, each on its
    ``<case>:``-prefixed inputs (``spawn_group``)."""
    out = {}
    for case in (str(c) for c in inp["cases"]):
        sub = {k.split(":", 1)[1]: v for k, v in inp.items()
               if k.startswith(case + ":")}
        out[case] = globals()[f"case_{case}"](sub, mesh_of)
    return out


@contextlib.contextmanager
def _sequence_sharding(on: bool):
    """``sharding.SEQUENCE_SHARDING`` set to ``on`` for the block."""
    from repro_torch import sharding
    prev = sharding.SEQUENCE_SHARDING
    sharding.SEQUENCE_SHARDING = on
    try:
        yield
    finally:
        sharding.SEQUENCE_SHARDING = prev


def _no_sequence_sharding(case):
    """A case that holds the layout without sequence sharding (the
    residual stream whole on every model rank), whose collectives its
    tests count by tag."""
    @functools.wraps(case)
    def run(inp, mesh_of):
        with _sequence_sharding(False):
            return case(inp, mesh_of)
    return run


def _tree(flat: dict, prefix: str) -> dict:
    """Nested dict of tensors from the ``prefix/a/b`` keys of an npz."""
    import torch
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        node = out
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(v, dtype=v.dtype))
    return out


def _to(tree: dict, dev) -> dict:
    """A copy of a nested dict of tensors (on ``dev``, or where it is)."""
    return {k: _to(v, dev) if isinstance(v, dict)
            else v.to(dev or v.device, copy=True) for k, v in tree.items()}


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def _batch(inp) -> dict:
    import torch
    return {k: torch.from_numpy(np.array(inp[k])) for k in ("tokens",
                                                          "labels")}


def case_gather(inp, mesh_of):
    import torch
    from repro_torch import sharding
    mesh = mesh_of((4, 2), ("data", "model"))
    specs = {"w": ("data", "model"), "v": (None, "data"), "g": ()}
    full = {k: torch.from_numpy(inp[k]) for k in specs}
    blocks = {k: b.requires_grad_(True)
              for k, b in sharding.shard(full, specs, mesh).items()}
    sharding.reset_stats()
    got = sharding.quantized_all_gather(blocks, mesh, bits=8, pspecs=specs)
    stats = dict(sharding.STATS)
    # each rank's term of the logical loss sum(gathered): the step's
    # convention, its backward seeded with 1 / ranks of the batch axes
    n = mesh.count(sharding.batch_axes(mesh))
    (sum(x.sum() for x in got.values()) / n).backward()
    return {"got": {k: v.detach() for k, v in got.items()},
            "grads": {k: b.grad for k, b in blocks.items()},
            "block_shapes": {k: tuple(b.shape) for k, b in blocks.items()},
            "stats": stats}


def case_compress(inp, mesh_of):
    import torch
    from repro_torch.core import grad_compress
    gs = torch.from_numpy(inp["gs"])
    npods = gs.shape[0]
    mesh = mesh_of((npods,), ("pod",))
    g = {"w": gs[mesh.rank]}
    kw = dict(bits=8, axis="pod", min_size=1, mesh=mesh)
    out1, res1 = grad_compress.compressed_psum_mean(
        g, grad_compress.init_residuals(g), **kw)
    out2, res2 = grad_compress.compressed_psum_mean(g, res1, **kw)
    o_no, _ = grad_compress.compressed_psum_mean(g, None, **kw)
    return {"out1": out1["w"], "res1": res1["w"], "out2": out2["w"],
            "res2": res2["w"], "out_no_ef": o_no["w"]}


def _qwen_step_inputs(inp):
    from repro_torch.configs import registry
    cfg = registry.get_config("qwen1.5-0.5b").reduced()
    return cfg, _tree(inp, "init"), _batch(inp)


@_no_sequence_sharding
def case_fp32_step(inp, mesh_of):
    from repro_torch import sharding
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt_lib, trainer
    mesh = mesh_of((2, 2), ("data", "model"))
    cfg, init, batch = _qwen_step_inputs(inp)
    opt_cfg = opt_lib.OptimizerConfig(lr=1e-3)
    step = trainer.make_train_step(lm.lm_loss, cfg, QuantConfig.fp32(),
                                   opt_cfg)
    params, opt, pspecs = trainer.init_train_state(lambda k: init, None,
                                                   mesh, fsdp=True)
    stepj = trainer.jit_train_step(step, mesh, pspecs, donate=False)
    sharding.reset_stats()
    params, opt, m = stepj(params, opt, batch, None)
    return {"loss": float(m["loss"]), "stats": dict(sharding.STATS),
            "params": _flat(sharding.unshard(params, pspecs, mesh)),
            "specs": _flat(pspecs)}


def case_int8_step(inp, mesh_of):
    """The int8 round-to-nearest step on a data-2 mesh against the port's
    one-device step (on rank 0), recording every per-tensor exponent; and
    a quantize's exponent under ``spmd`` and inside
    ``manual_axes_active``."""
    import torch
    from repro_torch import sharding
    from repro_torch.core import dfx
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt_lib, trainer
    mesh = mesh_of((2, 1), ("data", "model"))
    cfg, init, batch = _qwen_step_inputs(inp)
    dev = torch.device(str(inp.get("device", "cpu")))
    if dev.type == "cuda":
        # both ranks share the card: their collectives stage through the host
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        init = _to(init, dev)
        batch = {k: v.to(dev) for k, v in batch.items()}
    q = dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)
    opt_cfg = opt_lib.OptimizerConfig(lr=1e-3)
    rec = _record_exponents(dfx)

    def copy(tree):
        return _to(tree, None)

    out = {}
    for mb in (1, 2):
        tcfg = trainer.TrainConfig(microbatches=mb)
        params, opt, pspecs = trainer.init_train_state(
            lambda k: copy(init), None, mesh, fsdp=True)
        step = trainer.jit_train_step(trainer.make_train_step(
            lm.lm_loss, cfg, q, opt_cfg, tcfg), mesh, pspecs)
        rec.clear()
        params, opt, m = step(params, opt, batch, None)
        dist_exps = list(rec)
        full = _flat(sharding.unshard(params, pspecs, mesh))
        rec.clear()
        one = trainer.make_train_step(lm.lm_loss, cfg, q, opt_cfg, tcfg)
        p1 = copy(init)
        p1, _, m1 = one(p1, opt_lib.init(p1), batch, None)
        out[mb] = {"loss": float(m["loss"]), "loss_one": float(m1["loss"]),
                   "exps": dist_exps, "exps_one": list(rec),
                   "params": _flat(_to(full, "cpu")),
                   "params_one": _flat(_to(p1, "cpu"))}
    # a rank-local tensor: its exponent under spmd, then under manual
    x = torch.full((4, 4), 0.75 * 4.0 ** mesh.rank, device=dev)
    with sharding.spmd(mesh):
        e_spmd = int(dfx.scale_exponent(x))
        with sharding.manual_axes_active(mesh.axis_names):
            e_manual = int(dfx.scale_exponent(x))
    out["local"] = {"spmd": e_spmd, "manual": e_manual,
                    "own": int(torch.frexp(x.abs().max())[1])}
    return out


def case_moe_layer(inp, mesh_of):
    """Reduced mixtral's MoE layer, FP32, on a data-2 mesh under
    ``sharding.spmd``: each rank its rows of the reference's input."""
    import torch
    from repro_torch import sharding
    from repro_torch.configs import registry
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import blocks
    from repro_torch.train import trainer
    mesh = mesh_of((2, 1), ("data", "model"))
    cfg = registry.get_config("mixtral-8x7b").reduced()
    tree = _tree(inp, "moe_in")
    x = torch.from_numpy(np.ascontiguousarray(
        trainer.local_rows({"x": inp["moe_x"]}, mesh)["x"]))
    T = x.shape[0] * x.shape[1]
    with sharding.spmd(mesh):
        y, aux = blocks.moe_apply(tree, x, cfg, QuantConfig.fp32(), None)
        cap = blocks.capacity(cfg, T, 2)
    # the rank's first choices per expert, past the capacity: the drops
    probs = torch.softmax(x.reshape(T, -1) @ tree["router"], dim=-1)
    sel = torch.topk(probs, cfg.moe_topk).indices.reshape(-1)
    over = torch.bincount(sel, minlength=cfg.moe_experts) - cap
    return {"y": y, "aux": float(aux), "cap": cap,
            "dropped": int(over.clamp(min=0).sum())}


def case_int8_moe_step(inp, mesh_of):
    """Reduced mixtral, int8 round to nearest, on a data-2 mesh against
    the port's one-device step, with labels masked unevenly over the
    ranks' rows; every per-tensor exponent recorded."""
    from repro_torch import sharding
    from repro_torch.configs import registry
    from repro_torch.core import dfx
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt_lib, trainer
    import torch
    mesh = mesh_of((2, 1), ("data", "model"))
    cfg = registry.get_config("mixtral-8x7b").reduced()
    init = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = _batch(inp)
    q = dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)
    opt_cfg = opt_lib.OptimizerConfig(lr=1e-3)
    rec = _record_exponents(dfx)
    params, opt, pspecs = trainer.init_train_state(
        lambda k: _to(init, None), None, mesh, fsdp=True)
    step = trainer.jit_train_step(trainer.make_train_step(
        lm.lm_loss, cfg, q, opt_cfg), mesh, pspecs)
    params, opt, m = step(params, opt, batch, None)
    exps = list(rec)
    full = _flat(sharding.unshard(params, pspecs, mesh))
    rec.clear()
    p1 = _to(init, None)
    p1, _, m1 = trainer.make_train_step(lm.lm_loss, cfg, q, opt_cfg)(
        p1, opt_lib.init(p1), batch, None)
    return {"loss": float(m["loss"]), "loss_one": float(m1["loss"]),
            "aux": float(m["aux"]), "aux_one": float(m1["aux"]),
            "exps": exps, "exps_one": list(rec), "params": full,
            "params_one": _flat(p1)}


def _record_exponents(dfx) -> list:
    """Every per-tensor and per-slice exponent ``dfx`` returns from now
    on, in order (the list, cleared by the caller)."""
    rec = []
    orig = dfx.scale_exponent, dfx.slice_exponents

    def scale_exponent(x):
        e = orig[0](x)
        rec.append(int(e))
        return e

    def slice_exponents(x):
        e = orig[1](x)
        rec.extend(int(v) for v in e)
        return e
    dfx.scale_exponent, dfx.slice_exponents = scale_exponent, slice_exponents
    return rec


def case_state_plane(inp, mesh_of):
    from repro_torch.configs import registry
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train import finetune, optimizer as opt_lib, trainer
    import torch
    mesh = mesh_of((4, 2), ("data", "model"))
    cfg = registry.get_config("smollm-135m").reduced()
    steps = int(inp["steps"])

    def run(gather_bits, state_bits):
        opt_cfg = opt_lib.OptimizerConfig(lr=2e-3, weight_decay=0.0,
                                          state_bits=state_bits)
        params, opt_state, pspecs = trainer.init_train_state(
            lambda g: lm.lm_init(g, cfg, device="cpu"),
            torch.Generator().manual_seed(0), mesh, fsdp=True,
            opt_cfg=opt_cfg)
        step = trainer.jit_train_step(trainer.make_train_step(
            lm.lm_loss, cfg, QuantConfig.fp32(), opt_cfg,
            trainer.TrainConfig(gather_bits=gather_bits)), mesh, pspecs)
        data = SyntheticLM(DataConfig(batch_size=8, seq_len=32,
                                      vocab=cfg.vocab, seed=3))
        losses = []
        for _ in range(steps):
            batch = finetune.to_device(next(data), "cpu")
            params, opt_state, m = step(params, opt_state, batch, None)
            losses.append(float(m["loss"]))
        return losses

    return {"base": run(0, 0), "quant": run(8, 8)}


def case_chaos(inp, mesh_of):
    import torch
    from repro_torch import sharding
    from repro_torch.configs import registry
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train import (chaos, checkpoint, fault, finetune,
                                   optimizer as opt_lib, trainer)
    mesh = mesh_of((2, 2), ("data", "model"))
    cfg = registry.get_config("smollm-135m").reduced()
    opt_cfg = opt_lib.OptimizerConfig(lr=1e-3)
    params, opt_state, pspecs = trainer.init_train_state(
        lambda g: lm.lm_init(g, cfg, device="cpu"),
        torch.Generator().manual_seed(0), mesh, fsdp=True)
    step = trainer.jit_train_step(trainer.make_train_step(
        lm.lm_loss, cfg, QuantConfig.int8(), opt_cfg), mesh, pspecs,
        donate=False)
    layout = (mesh, {"params": pspecs, "opt": opt_lib.OptState(
        step=(), m=pspecs, v=pspecs), "data": None})
    dp = mesh.index(sharding.batch_axes(mesh))

    def run(ccfg, ckpt_dir, steps=14):
        data = SyntheticLM(DataConfig(batch_size=4, seq_len=32,
                                      vocab=cfg.vocab, seed=3))
        last = {}

        def one(state, k):
            p, o = state
            b = finetune.to_device(next(data), "cpu")
            # a key per (step, batch-axis rank): the reference's fold_in
            key = torch.Generator().manual_seed(1000 * k + dp)
            p, o, m = step(p, o, b, key)
            last["loss"] = float(m["loss"])
            return (p, o)

        def save_fn(state, k):
            checkpoint.save(ckpt_dir, k, {"params": state[0],
                                          "opt": state[1],
                                          "data": data.state()},
                            layout=layout)

        def restore_fn():
            got = checkpoint.restore_latest(
                ckpt_dir, {"params": params, "opt": opt_state,
                           "data": data.state()}, layout=layout)
            assert got is not None, "no usable checkpoint"
            blob, k = got
            data.restore(blob["data"])
            return (blob["params"], blob["opt"]), k

        def fresh(tree):
            # the loop updates in place: each run starts from a copy
            return sharding.map_state(lambda x, s: x.clone(), tree, pspecs)

        monkey = chaos.ChaosMonkey(ccfg, writer=mesh.rank == 0)
        state = (fresh(params), opt_lib.init(fresh(params)))
        events = []
        fault.run_with_recovery(
            monkey.wrap(one), state, start_step=0, num_steps=steps,
            save_fn=save_fn, restore_fn=restore_fn, save_every=4,
            on_event=events.append)
        return last["loss"], events

    root = os.path.join(os.environ["DIST_OUT"], "ckpt")
    clean, _ = run(chaos.ChaosConfig(), os.path.join(root, "clean"))
    hit, events = run(chaos.ChaosConfig(
        seed=11, preempt_at=(6,), bitflip_at=(9,), drop_psum_at=(12,),
        ckpt_dir=os.path.join(root, "chaos")), os.path.join(root, "chaos"))
    return {"clean": clean, "chaos": hit,
            "events": [e["type"] for e in events]}


def case_compressed_step(inp, mesh_of):
    from repro_torch.core import grad_compress
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt_lib, trainer
    mesh = mesh_of((2, 2, 1), ("pod", "data", "model"))
    cfg, params, batch = _qwen_step_inputs(inp)
    opt_cfg = opt_lib.OptimizerConfig(lr=1e-3)
    step = trainer.make_compressed_train_step(
        lm.lm_loss, cfg, QuantConfig.fp32(), opt_cfg, mesh,
        trainer.TrainConfig(grad_compress_bits=8))
    params, _, res, m = step(params, opt_lib.init(params),
                             grad_compress.init_residuals(params), batch,
                             None)
    return {"loss": float(m["loss"]), "params": _flat(params)}


# -------------------------------------------------------------------------
# Per-layer gathering (test_torch_fsdp_layers.py): one world, every case
# -------------------------------------------------------------------------

def _whole_model_placement(mesh, pspecs, gather_bits, microbatches):
    """The step that gathers every leaf before the forward and pulls every
    gradient back through the gathers after the backward: the parameters
    and gradients whole on every rank."""
    import torch
    from repro_torch import sharding
    from repro_torch.train import optimizer as opt_lib, trainer

    class WholeModel(trainer._Spmd):
        def view(self, params):
            return params

        def grads(self, grads_fn, params, batch, key):
            batch = trainer.local_rows(batch, self.mesh, self.microbatches,
                                       self.axes)
            live = opt_lib.tree_map(
                lambda p: p.detach().requires_grad_(True), params)
            with sharding.spmd(self.mesh):
                image = sharding.gather_params(live, self.specs, self.mesh,
                                               self.gather_bits)
                g_image, metrics = grads_fn(image, batch, key)
                blocks = torch.autograd.grad(opt_lib.tree_leaves(image),
                                             opt_lib.tree_leaves(live),
                                             opt_lib.tree_leaves(g_image))
            return (opt_lib.tree_unflatten(params, list(blocks)),
                    trainer._mean_metrics(metrics, self.mesh, self.axes))

    return WholeModel(mesh, pspecs, gather_bits, microbatches)


#: (arch, gather_bits, state_bits) of the equality cases
LAYER_CASES = {
    "qwen": ("qwen1.5-0.5b", 0, 0),
    "qwen_gather8": ("qwen1.5-0.5b", 8, 8),
    "mixtral": ("mixtral-8x7b", 0, 0),
    "mamba2": ("mamba2-370m", 0, 0),
    "zamba2": ("zamba2-2.7b", 0, 0),
    "whisper": ("whisper-large-v3", 0, 0),
}


def _layer_batch(cfg, rows=4, seq=32):
    import torch
    from repro_torch.launch import train as launch_train
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (rows, seq + 1))
    raw = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in launch_train.make_batch(cfg, raw).items()}


def _moments(opt, pspecs, mesh) -> dict:
    """Every logical moment: an FP32 tensor, or a QTensor's planes and
    exponents."""
    from repro_torch import sharding
    from repro_torch.core import qtensor
    out = {}
    for which in ("m", "v"):
        full = sharding.unshard(getattr(opt, which), pspecs, mesh)
        for k, x in _flat(full).items():
            if qtensor.is_qtensor(x):
                out[f"{which}/{k}/m"], out[f"{which}/{k}/exp"] = x.m, x.exp
            else:
                out[f"{which}/{k}"] = x
    return out


def _layer_step(name, mesh, rec, microbatches=1, where="layer"):
    """One step of ``LAYER_CASES[name]`` from a seeded init: on ``mesh``
    per layer (``where="layer"``) or with every leaf gathered whole
    (``"whole"``), or on one device (``"one"``, no mesh).  The loss, the
    logical parameters and moments, every exponent, the collectives by
    tag."""
    import torch
    from repro_torch import sharding
    from repro_torch.configs import registry
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.train import optimizer as opt_lib, trainer
    arch, gather_bits, state_bits = LAYER_CASES[name]
    cfg = registry.get_config(arch).reduced()
    init_fn, loss_fn = launch_train._model(cfg)
    q = dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)
    opt_cfg = opt_lib.OptimizerConfig(lr=1e-3, state_bits=state_bits)
    tcfg = trainer.TrainConfig(microbatches=microbatches,
                               gather_bits=gather_bits)
    step = trainer.make_train_step(loss_fn, cfg, q, opt_cfg, tcfg)
    gen = torch.Generator().manual_seed(0)
    if where == "one":
        params = init_fn(gen, cfg, device="cpu")
        opt = opt_lib.init(params, opt_cfg)
    else:
        params, opt, pspecs = trainer.init_train_state(
            lambda g: init_fn(g, cfg, device="cpu"), gen, mesh, fsdp=True,
            opt_cfg=opt_cfg)
        step = (step.on(_whole_model_placement(mesh, pspecs, gather_bits,
                                               microbatches))
                if where == "whole" else
                trainer.jit_train_step(step, mesh, pspecs))
    sharding.reset_stats()
    rec.clear()
    params, opt, m = step(params, opt, _layer_batch(cfg), None)
    out = {"loss": float(m["loss"]), "exps": list(rec),
           "stats": dict(sharding.STATS),
           "largest": dict(sharding.LARGEST)}
    if where == "one":
        return dict(out, params=_flat(params))
    return dict(out, params=_flat(sharding.unshard(params, pspecs, mesh)),
                moments=_moments(opt, pspecs, mesh))


def _layer_footprint(name, mesh) -> dict:
    """What the per-layer gathers of ``name``'s step should show, from its
    specs: the data-sharded stacked leaves, the layers, one layer's
    largest logical bytes on the wire, the leaves gathered whole."""
    import torch
    from repro_torch import sharding
    from repro_torch.configs import registry
    from repro_torch.core import qtensor
    from repro_torch.launch import train as launch_train
    from repro_torch.train import optimizer as opt_lib
    arch, gather_bits, _ = LAYER_CASES[name]
    cfg = registry.get_config(arch).reduced()
    full = launch_train._model(cfg)[0](torch.Generator().manual_seed(0),
                                       cfg, device="cpu")
    specs = sharding.param_pspecs(full, mesh, fsdp=True)
    paths = opt_lib.tree_paths(full)
    leaves = list(zip(paths, opt_lib.tree_leaves(full),
                      opt_lib.tree_leaves(specs)))
    stacked = [(p, s) for path, p, s in leaves if opt_lib.is_stacked(path)]
    whole = [(p, s) for path, p, s in leaves
             if not opt_lib.is_stacked(path)]
    travel = [(p, s) for p, s in stacked
              if sharding.sharded_axes(s, mesh)]
    # a data-sharded layer moves as int8 planes under the int8 gather
    limbs = qtensor.n_limbs(gather_bits) if gather_bits else 4
    return {"layers": cfg.n_layers, "stacked": len(stacked),
            "travel": len(travel),
            "data": sum("data" in s for p, s in travel),
            "layer_bytes": max(p[0].numel() * (limbs if "data" in s else 4)
                               for p, s in travel),
            "whole": len(whole),
            "whole_travel": sum(bool(sharding.sharded_axes(s, mesh))
                                for p, s in whole),
            "whole_bytes": max(4 * p.numel() for p, s in whole)}


def _layer_noise(mesh) -> dict:
    """A stacked and a whole leaf's moment noise: the rank's block drawn
    per slice, and the one-device draw's block."""
    from repro_torch import sharding
    from repro_torch.train import optimizer as opt_lib
    out = {}
    for name, shape, spec, stacked in (
            ("stacked", (3, 8, 6), (None, "data", None), True),
            ("whole", (8, 6), ("data", None), False)):
        sl = sharding.local_slices(shape, spec, mesh)
        block = tuple(s.stop - s.start for s in sl)
        got = opt_lib.moment_noise(5, 2, 7, "v", "cpu", shape, stacked, sl)
        one = opt_lib.moment_noise(5, 2, 7, "v", "cpu", shape, stacked)
        out[name] = {"block": _uniform(got, block), "one": _uniform(
            one, shape)[sl]}
    return out


def _uniform(key, shape):
    from repro_torch.core import dfx
    return dfx.uniform(key, shape, "cpu")


def case_fsdp_layers(inp, mesh_of):
    """Every case of test_torch_fsdp_layers.py on one data-2 world."""
    from repro_torch.core import dfx
    mesh = mesh_of((2, 1), ("data", "model"))
    rec = _record_exponents(dfx)
    out = {"equal": {}, "footprint": {}}
    for name in LAYER_CASES:
        out["equal"][name] = {w: _layer_step(name, mesh, rec, where=w)
                              for w in ("layer", "whole")}
        out["footprint"][name] = _layer_footprint(name, mesh)
    out["micro"] = {w: _layer_step("qwen", mesh, rec, 2, where=w)
                    for w in ("layer", "one")}
    out["noise"] = _layer_noise(mesh)
    return out


# -------------------------------------------------------------------------
# Tensor-parallel compute (test_torch_tensor_parallel.py)
# -------------------------------------------------------------------------

def _rn_int8():
    from repro_torch.core.qconfig import QuantConfig
    return dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)


def case_tp_ops(inp, mesh_of):
    """The split products on a (1, M) mesh from the whole operands in
    ``inp``: a column- and a row-parallel ``int_linear`` (int8, round to
    nearest), the vocab-parallel embedding and cross entropy; each output
    and gradient as the rank holds it."""
    import torch
    from repro_torch import sharding
    from repro_torch.core import int_ops
    from repro_torch.models import lm
    M = int(inp["model"])
    mesh = mesh_of((1, M), ("data", "model"))
    r = mesh.index("model")
    q = _rn_int8()
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    K, N = t["w"].shape
    V = t["table"].shape[0]
    cols, rows = slice(r * N // M, (r + 1) * N // M), slice(
        r * K // M, (r + 1) * K // M)
    vrows = slice(r * V // M, (r + 1) * V // M)

    def leaf(x):
        return x.clone().requires_grad_(True)
    out = {}
    with sharding.spmd(mesh, split=True):
        x, w, b = leaf(t["x"]), leaf(t["w"][:, cols]), leaf(t["b"][cols])
        y = int_ops.int_linear(int_ops.copy_to_model(x), w, b, None, q,
                               split="col")
        y.backward(t["gy"][..., cols])
        out["col"] = {"y": y.detach(), "dx": x.grad, "dw": w.grad,
                      "db": b.grad}
        x, w = leaf(t["x"][..., rows]), leaf(t["w"][rows])
        y = int_ops.int_linear(x, w, t["b"], None, q, split="row")
        y.backward(t["gy"])
        out["row"] = {"y": y.detach(), "dx": x.grad, "dw": w.grad}
        table = leaf(t["table"][vrows])
        y = int_ops.int_embedding(table, t["ids"], None, q,
                                  vocab_start=r * V // M)
        y.backward(t["gemb"])
        out["emb"] = {"y": y.detach(), "dt": table.grad}
        z = leaf(t["logits"][..., vrows])
        loss = lm.token_ce_vocab_parallel(z, t["labels"])
        loss.backward()
        out["ce"] = {"loss": loss.detach(), "dz": z.grad}
    return out


def _tp_arch(name):
    from repro_torch.configs import registry
    return registry.get_config(name).reduced()


@_no_sequence_sharding
def case_tp_fp32_step(inp, mesh_of):
    """One FP32 AdamW step of each arch in ``inp["archs"]`` on the mesh
    ``inp["mesh"]`` from the reference's weights and batch
    (``<arch>/init/...``, ``<arch>/tokens``, ``<arch>/labels``): the loss,
    the logical parameters, the collectives by tag."""
    return _tp_fp32_step(inp, mesh_of)


def case_sp_fp32_step(inp, mesh_of):
    """``case_tp_fp32_step`` under sequence sharding."""
    with _sequence_sharding(True):
        return _tp_fp32_step(inp, mesh_of)


def _tp_fp32_step(inp, mesh_of):
    import torch
    from repro_torch import sharding
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt_lib, trainer
    mesh = mesh_of(tuple(int(v) for v in inp["mesh"]), ("data", "model"))
    out = {}
    for arch in (str(a) for a in inp["archs"]):
        cfg = _tp_arch(arch)
        init = _tree(inp, f"{arch}/init")
        batch = {k: torch.from_numpy(np.array(inp[f"{arch}/{k}"]))
                 for k in ("tokens", "labels")}
        opt_cfg = opt_lib.OptimizerConfig(lr=1e-3)
        params, opt, pspecs = trainer.init_train_state(
            lambda k: init, None, mesh, fsdp=True)
        step = trainer.jit_train_step(trainer.make_train_step(
            lm.lm_loss, cfg, QuantConfig.fp32(), opt_cfg), mesh, pspecs)
        sharding.reset_stats()
        params, opt, m = step(params, opt, batch, None)
        out[arch] = {"loss": float(m["loss"]),
                     "params": _flat(sharding.unshard(params, pspecs, mesh)),
                     "stats": dict(sharding.STATS)}
    return out


def _grads_and_exps(cfg, init, batch, mesh, rec, loss_fn=None):
    """The int8 round-to-nearest loss, gradients and exponents of one
    ``loss_fn`` step (default ``lm_loss``) on ``mesh`` (the logical
    gradients), or on one device (``mesh`` None); with the collectives by
    tag."""
    from repro_torch import sharding
    from repro_torch.models import lm
    from repro_torch.train import trainer
    q = _rn_int8()
    loss_fn = loss_fn or lm.lm_loss
    if mesh is None:
        rec.clear()
        loss, _, grads = trainer.loss_and_grads(loss_fn, _to(init, None),
                                                batch, cfg, q, None)
        return {"loss": float(loss), "exps": list(rec),
                "grads": _flat(grads)}
    params, _, pspecs = trainer.init_train_state(
        lambda k: _to(init, None), None, mesh, fsdp=True)
    where = trainer.placement(mesh, pspecs, cfg=cfg)
    grads_fn = trainer.make_grads_fn(loss_fn, cfg, q, 1,
                                     grad_scale=where.scale, view=where.view)
    sharding.reset_stats()
    rec.clear()
    grads, metrics = where.grads(grads_fn, params, batch, None)
    out = {"loss": float(metrics["loss"]), "exps": list(rec),
           "stats": dict(sharding.STATS), "largest": dict(sharding.LARGEST)}
    out["grads"] = _flat(sharding.unshard(grads, pspecs, mesh))
    return out


@_no_sequence_sharding
def case_tp_int8(inp, mesh_of):
    """Reduced qwen1.5-0.5b and mixtral-8x7b (``inp["archs"]``), int8 round
    to nearest, from a seeded init: the gradients of one step on each mesh
    of ``inp["meshes"]`` against the port's one-device gradients, every
    exponent recorded on both sides.  ``{"DxM": {arch: {"mesh", "one"}}}``."""
    import torch
    from repro_torch.core import dfx
    from repro_torch.models import lm
    rec = _record_exponents(dfx)
    out = {}
    for shape in inp["meshes"]:
        shape = tuple(int(v) for v in shape)
        mesh = mesh_of(shape, ("data", "model"))
        got = out["x".join(map(str, shape))] = {}
        for arch in (str(a) for a in inp["archs"]):
            cfg = _tp_arch(arch)
            init = lm.lm_init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
            batch = _layer_batch(cfg)
            got[arch] = {
                "mesh": _grads_and_exps(cfg, init, batch, mesh, rec),
                "one": _grads_and_exps(cfg, init, batch, None, rec)}
    return out


# -------------------------------------------------------------------------
# Tensor-parallel compute for the SSM, hybrid and enc-dec stacks
# (test_torch_tensor_parallel_state.py)
# -------------------------------------------------------------------------

def _tp_state_batch(inp, arch, cfg) -> dict:
    """``<arch>/tokens``, ``/labels`` and (enc-dec) ``/frames`` of ``inp``
    as tensors."""
    import torch
    keys = ("tokens", "labels") + (("frames",) if cfg.enc_dec else ())
    return {k: torch.from_numpy(np.array(inp[f"{arch}/{k}"])) for k in keys}


@_no_sequence_sharding
def case_tp_state_fp32(inp, mesh_of):
    """One FP32 AdamW step of each reduced arch in ``inp["archs"]`` on the
    mesh ``inp["mesh"]`` from the reference's weights and batch: the loss,
    the logical parameters, the collectives by tag."""
    from repro_torch import sharding
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.train import optimizer as opt_lib, trainer
    mesh = mesh_of(tuple(int(v) for v in inp["mesh"]), ("data", "model"))
    out = {}
    for arch in (str(a) for a in inp["archs"]):
        cfg = _tp_arch(arch)
        init = _tree(inp, f"{arch}/init")
        params, opt, pspecs = trainer.init_train_state(
            lambda k: init, None, mesh, fsdp=True)
        step = trainer.jit_train_step(trainer.make_train_step(
            launch_train._model(cfg)[1], cfg, QuantConfig.fp32(),
            opt_lib.OptimizerConfig(lr=1e-3)), mesh, pspecs)
        sharding.reset_stats()
        params, opt, m = step(params, opt, _tp_state_batch(inp, arch, cfg),
                              None)
        out[arch] = {"loss": float(m["loss"]),
                     "params": _flat(sharding.unshard(params, pspecs, mesh)),
                     "stats": dict(sharding.STATS)}
    return out


@_no_sequence_sharding
def case_tp_state_int8(inp, mesh_of):
    """The int8 round-to-nearest gradients of one step of each
    ``"<D>x<M>:<arch>"`` in ``inp["runs"]`` (a reduced arch from a seeded
    init, the batch in ``inp``) on that mesh and on one device, every
    exponent recorded on both sides.  ``{"DxM": {arch: {"mesh", "one"}}}``."""
    import torch
    from repro_torch.core import dfx
    from repro_torch.launch import train as launch_train
    rec = _record_exponents(dfx)
    out = {}
    for run in (str(r) for r in inp["runs"]):
        name, arch = run.split(":")
        mesh = mesh_of(tuple(int(v) for v in name.split("x")),
                       ("data", "model"))
        cfg = _tp_arch(arch)
        init_fn, loss_fn = launch_train._model(cfg)
        init = init_fn(torch.Generator().manual_seed(0), cfg, device="cpu")
        batch = _tp_state_batch(inp, arch, cfg)
        got = {"mesh": _grads_and_exps(cfg, init, batch, mesh, rec,
                                       loss_fn)}
        if mesh.rank == 0:      # the one-device step, on rank 0 alone
            got["one"] = _grads_and_exps(cfg, init, batch, None, rec,
                                         loss_fn)
        out.setdefault(name, {})[arch] = got
    return out


# -------------------------------------------------------------------------
# Sequence parallelism (test_torch_sequence_parallel.py)
# -------------------------------------------------------------------------

def case_sp_ops(inp, mesh_of):
    """The sequence-parallel operators and ops on a (1, 2) mesh from the
    whole operands in ``inp`` (int8, round to nearest), each as the rank
    holds it: the all-gather and the reduce-scatter forward and backward;
    the row-parallel ``int_linear`` reduce-scattered and all-reduced;
    ``int_rmsnorm`` / ``int_layernorm`` on the rank's rows (with the
    mantissas and exponent of their input's quantize) and on the whole
    rows."""
    import torch
    from repro_torch import sharding
    from repro_torch.core import dfx, int_ops
    mesh = mesh_of((1, 2), ("data", "model"))
    r = mesh.index("model")
    q = _rn_int8()
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    S, K = t["x"].shape[1], t["x"].shape[-1]
    rows, ks = slice(r * S // 2, (r + 1) * S // 2), slice(r * K // 2,
                                                         (r + 1) * K // 2)

    def leaf(x):
        return x.clone().requires_grad_(True)
    out = {}
    sharding.reset_stats()
    with sharding.spmd(mesh, split=True, sequence=True):
        x = leaf(t["x"][:, rows])
        full = int_ops.gather_from_sequence(x)[0]
        full.backward(t["gfull"][r])
        out["gather"] = {"y": full.detach(), "dx": x.grad}
        y = leaf(t["gfull"][r])
        part = int_ops.reduce_scatter_to_sequence(y)
        part.backward(t["gnorm"][:, rows])
        out["scatter"] = {"y": part.detach(), "dy": y.grad}
        out["stats"] = dict(sharding.STATS)      # the two operators'
        for seq in (True, False):
            x, w, b = leaf(t["x"][..., ks]), leaf(t["w"][ks]), leaf(t["b"])
            y = int_ops.int_linear(x, w, b, None, q, split="row", seq=seq)
            y.backward(t["gy"][:, rows] if seq else t["gy"])
            out[f"row_{seq}"] = {"y": y.detach(), "dx": x.grad,
                                 "dw": w.grad, "db": b.grad}
        for norm in ("rms", "ln"):
            for seq in (True, False):
                x = leaf(t["x"][:, rows] if seq else t["x"])
                g, bias = leaf(t["gamma"]), leaf(t["beta"])
                with dfx.split(seq):
                    qx = dfx.quantize(x.detach(), q.act_bits)
                if norm == "rms":
                    y = int_ops.int_rmsnorm(x, g, None, q, seq=seq)
                else:
                    y = int_ops.int_layernorm(x, g, bias, None, q, seq=seq)
                y.backward(t["gnorm"][:, rows] if seq else t["gnorm"])
                out[f"{norm}_{seq}"] = {
                    "y": y.detach(), "m": qx.m, "exp": int(qx.exp),
                    "dx": x.grad, "dg": g.grad,
                    "db": bias.grad if norm == "ln" else None}
    return out


def _sp_grads(cfg, init, batch, mesh, rec, loss_fn, q, seed):
    """One step's loss, logical gradients, exponents (in order) and
    collectives by tag on ``mesh`` at ``q``, every rank's generator seeded
    with ``seed`` (None: no key)."""
    import torch
    from repro_torch import sharding
    from repro_torch.train import trainer
    params, _, pspecs = trainer.init_train_state(
        lambda k: _to(init, None), None, mesh, fsdp=True)
    where = trainer.placement(mesh, pspecs, cfg=cfg)
    grads_fn = trainer.make_grads_fn(loss_fn, cfg, q, 1,
                                     grad_scale=where.scale, view=where.view)
    key = None if seed is None else torch.Generator().manual_seed(seed)
    sharding.reset_stats()
    rec.clear()
    grads, metrics = where.grads(grads_fn, params, batch, key)
    return {"loss": float(metrics["loss"]), "exps": list(rec),
            "stats": dict(sharding.STATS), "largest": dict(sharding.LARGEST),
            "grads": _flat(sharding.unshard(grads, pspecs, mesh))}


def case_sp_step(inp, mesh_of):
    """Each ``"<D>x<M>:<arch>[:<S>][:sr]"`` of ``inp["runs"]``: one step of
    the reduced arch from a seeded init over a batch of 4 rows of ``S``
    (default 32) positions, on that mesh under sequence sharding
    (``"sp"``) and with ``sharding.SEQUENCE_SHARDING`` False (``"no"``),
    int8 round to nearest, or with ``sr`` stochastic rounding forward and
    backward from one seed.  ``{run: {"sp", "no"}}``."""
    import torch
    from repro_torch.core import dfx
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.launch import train as launch_train
    rec = _record_exponents(dfx)
    out = {}
    for run in (str(r) for r in inp["runs"]):
        name, arch, *rest = run.split(":")
        mesh = mesh_of(tuple(int(v) for v in name.split("x")),
                       ("data", "model"))
        cfg = _tp_arch(arch)
        sr = "sr" in rest
        S = int(next((v for v in rest if v.isdigit()), 32))
        q = (dataclasses.replace(QuantConfig.int8(), stochastic_fwd=True)
             if sr else _rn_int8())
        init_fn, loss_fn = launch_train._model(cfg)
        init = init_fn(torch.Generator().manual_seed(0), cfg, device="cpu")
        batch = _layer_batch(cfg, seq=S)
        if cfg.enc_dec:
            # the encoder's stream apart from the decoder's
            batch["frames"] = torch.from_numpy(np.random.default_rng(1).normal(
                size=(4, FRAMES, cfg.d_model)).astype(np.float32))
        got = out[run] = {}
        for mode, on in (("sp", True), ("no", False)):
            with _sequence_sharding(on):
                got[mode] = _sp_grads(cfg, init, batch, mesh, rec, loss_fn,
                                      q, 3 if sr else None)
    return out


#: the encoder's frames of ``case_sp_step``'s enc-dec batch
FRAMES = 48


def case_zero_part_exponent(inp, mesh_of):
    """Under ``sharding.spmd`` over a data axis of the world: the
    exponent of a tensor whose part on one rank is all zero, and of a
    stack whose slice 1 is all zero on that rank, as every rank sees
    them."""
    import torch
    from repro_torch import sharding
    from repro_torch.core import dfx
    world = int(inp["world"])
    mesh = mesh_of((world, 1), ("data", "model"))
    x = torch.full((4, 4), 3e-6) if mesh.rank == 0 else torch.zeros(4, 4)
    st = torch.full((3, 4, 4), 3e-6)
    if mesh.rank:
        st[1] = 0
    with sharding.spmd(mesh):
        return {"one": int(dfx.scale_exponent(x)),
                "stack": dfx.slice_exponents(st).tolist()}


def case_dry_stats(inp, mesh_of):
    """The dry-run's reduced qwen1.5-0.5b train cell (``launch/dryrun.py
    ::build_cell``: int8, ``OptimizerConfig()``, the arch's fsdp) on a real
    (data 2, model 2) world, sequence-sharded and not: the rank's
    ``sharding.STATS`` of one step each."""
    import torch
    from repro_torch import sharding
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt_lib, trainer
    mesh = mesh_of((2, 2), ("data", "model"))
    cfg = registry.get_config("qwen1.5-0.5b").reduced()
    toks = torch.from_numpy(inp["tokens"])
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    out = {}
    for mode, on in (("baseline", True), ("no_sp", False)):
        with _sequence_sharding(on):
            params, opt, pspecs = trainer.init_train_state(
                lambda g: lm.lm_init(g, cfg, device="cpu"),
                torch.Generator().manual_seed(0), mesh,
                fsdp=registry.use_fsdp("qwen1.5-0.5b"),
                opt_cfg=opt_lib.OptimizerConfig())
            step = trainer.jit_train_step(trainer.make_train_step(
                lm.lm_loss, cfg, registry.get_quant("int8"),
                opt_lib.OptimizerConfig()), mesh, pspecs)
            sharding.reset_stats()
            step(params, opt, batch, torch.Generator().manual_seed(1))
            out[mode] = dict(sharding.STATS)
    return out


# -------------------------------------------------------------------------
# Serving under a mesh (test_torch_serve_mesh.py)
# -------------------------------------------------------------------------

#: the reduced archs the 2-rank world serves: name -> (arch, replace)
SERVE_ARCHS = {"qwen": ("qwen1.5-0.5b", {}),
               "qwen_kv1": ("qwen1.5-0.5b", {"n_kv_heads": 1}),
               "moe": ("qwen2-moe-a2.7b", {}),
               "mamba2": ("mamba2-370m", {}),
               "zamba2": ("zamba2-2.7b", {}),
               "llava": ("llava-next-mistral-7b", {}),
               "whisper": ("whisper-large-v3", {})}


def _serve_cfg(name):
    from repro_torch.configs import registry
    arch, repl = SERVE_ARCHS[name]
    return dataclasses.replace(registry.get_config(arch).reduced(), **repl)


def _serve_generate(cfg, params, q, prompts, new, mesh):
    """``Engine.generate`` under ``mesh`` (``sharding.set_mesh``; None: one
    device): the tokens, the whole logits of every step, the engine's
    cache (updated in place) and the collectives by tag."""
    import torch
    from repro_torch import sharding
    from repro_torch.serve.engine import Engine, ServeConfig
    sharding.reset_stats()
    sharding.set_mesh(mesh)
    try:
        eng = Engine(params, cfg, q, ServeConfig(max_seq=32, batch_slots=2),
                     device="cpu")
        seen, caches = [], []
        sample, init = eng._sample, eng.init_cache

        def recorded(logits, gen=None):
            seen.append(logits[:, -1].clone())
            return sample(logits, gen)

        def kept(batch):
            caches.append(init(batch))
            return caches[-1]
        eng._sample, eng.init_cache = recorded, kept
        toks = eng.generate(prompts, new)
    finally:
        sharding.set_mesh(None)
    return {"tokens": torch.from_numpy(toks), "logits": torch.stack(seen),
            "cache": caches[0], "stats": dict(sharding.STATS)}


def _serve_llava(cfg, params, q, tokens, pe, mesh):
    """``lm_prefill`` with the patch prefix, on one device or under
    ``sharding.serving``: the whole last-position logits and hidden
    states (the rank's rows of them under the mesh)."""
    import torch
    from repro_torch import sharding
    from repro_torch.models import lm
    with torch.no_grad():
        if mesh is None:
            logits, x = lm.lm_prefill(params, tokens, cfg, q,
                                      prefix_embeds=pe)
            return {"logits": logits[:, -1][None], "x": x}
        like = lm.lm_init(torch.Generator(), cfg, device="meta")
        blocks, specs = sharding.serve_blocks(params, like, mesh)
        with sharding.serving(mesh, specs, cfg, tokens.shape[0]) as s:
            logits, x = lm.lm_prefill(s.view(blocks), s.rows(tokens), cfg, q,
                                      prefix_embeds=s.rows(pe))
            return {"logits": s.logits(logits)[:, -1][None], "x": x}


def _serve_whisper(cfg, params, q, frames, toks, mesh):
    """``encode``, ``encdec_precompute_cross`` and one decode step per row
    of ``toks`` (steps, B, 1), on one device or under
    ``sharding.serving``: the whole logits of every step, the (rank's)
    cross K/V and self cache."""
    import torch
    from repro_torch import sharding
    from repro_torch.models import encdec
    B = frames.shape[0]

    def run(view, rows, logits_of, m):
        enc = encdec.encode(view, rows(frames), cfg, q, None)
        cross = encdec.encdec_precompute_cross(view, enc, cfg, q)
        cache = encdec.encdec_init_cache(cfg, B, 16, dtype=torch.float32,
                                         device="cpu", mesh=m)
        seen = []
        for t in toks:
            logits, cache = encdec.encdec_decode_step(
                view, rows(t), cache, cross, cfg, q)
            seen.append(logits_of(logits)[:, -1])
        return {"logits": torch.stack(seen), "cache": cache,
                "cross": dict(zip(("xk", "xv"), cross))}
    with torch.no_grad():
        if mesh is None:
            return run(params, lambda t: t, lambda z: z, None)
        like = encdec.encdec_init(torch.Generator(), cfg, device="meta")
        blocks, specs = sharding.serve_blocks(params, like, mesh)
        with sharding.serving(mesh, specs, cfg, B) as s:
            return run(s.view(blocks), s.rows, s.logits, mesh)


def _serve_block(one, like, mesh, cfg):
    """The rank's block of each one-device cache leaf (``cache_slices``
    over ``cache_pspecs``)."""
    from repro_torch import sharding
    specs = sharding.cache_pspecs(like, mesh, cfg)
    return {k: v[sharding.cache_slices(v.shape, specs[k], mesh, cfg)]
            for k, v in one.items()}


def case_serve_mesh(inp, mesh_of):
    """Each reduced arch of ``inp["names"]`` served on a (1, 2) mesh and on
    one device (both on every rank, the one-device run with the mesh
    uninstalled), int8 round to nearest, every exponent recorded: the
    dense, MoE, SSM and hybrid archs through ``Engine.generate`` (the qwen
    weights ``inp["qwen/init/..."]`` where given), llava's ``lm_prefill``
    with its patch prefix, whisper's decode.  ``{name: {"mesh", "one",
    "block"}}``: the runs, and the one-device run's cache cut to the
    rank's block."""
    import torch
    from repro_torch.core import dfx
    from repro_torch.launch import train as launch_train
    rec = _record_exponents(dfx)
    mesh = mesh_of((1, 2), ("data", "model"))
    q = _rn_int8()
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()
         if "/init/" not in k and k != "names"}
    out = {}
    for name in (str(n) for n in inp["names"]):
        cfg = _serve_cfg(name)
        init_fn = launch_train._model(cfg)[0]
        params = (_tree(inp, "qwen/init") if name == "qwen"
                  and any(k.startswith("qwen/init/") for k in inp) else
                  init_fn(torch.Generator().manual_seed(0), cfg,
                          device="cpu"))
        got = {}
        for where, m in (("one", None), ("mesh", mesh)):
            rec.clear()
            if cfg.enc_dec:
                r = _serve_whisper(cfg, params, q, t["frames"],
                                   t["dec"][..., None], m)
            elif cfg.vlm_prefix:
                r = _serve_llava(cfg, params, q, t["prompts"],
                                 t["patches"], m)
            else:
                r = _serve_generate(cfg, params, q, inp["prompts"],
                                    int(inp["new"]), m)
            got[where] = dict(r, exps=list(rec))
        if "cache" in got["one"]:
            like = {k: v.to("meta") for k, v in got["one"]["cache"].items()}
            got["block"] = _serve_block(got["one"]["cache"], like, mesh, cfg)
        out[name] = got
    return out


def _batcher_run(engine, cfg, requests):
    """A ``ContinuousBatcher`` over ``requests`` (prompt, budget, the step
    it arrives at): each request's per-step logits rows, and the
    results."""
    from repro_torch.serve.engine import ContinuousBatcher
    b = ContinuousBatcher(engine)
    pending = sorted(requests, key=lambda r: r[2])
    order, traj, steps = [], {}, 0
    while pending or b.queue or any(s.active for s in b.slots):
        while pending and pending[0][2] <= steps:
            p, n, _ = pending.pop(0)
            order.append(b.submit(p, n))
        b.step()
        steps += 1
        for i, s in enumerate(b.slots):
            if s.active:
                traj.setdefault(s.request_id, []).append(
                    b._logits[i, 0, :cfg.vocab].clone())
        assert steps < 200
    return {rid: {"logits": traj.get(rid, []), "tokens": b.results[rid]}
            for rid in order}


def case_serve_batcher(inp, mesh_of):
    """Reduced qwen1.5-0.5b through ``ContinuousBatcher`` on a (2, 2) mesh
    with staggered admissions (``inp["arrive"]``): under FP32 each request
    also alone on one device, under int8 round to nearest the same
    schedule on one device, every exponent recorded; and one prompt
    through ``Engine.generate``, a row every rank holds, and four from
    the rank's FSDP blocks.  ``{"fp32": {"mesh", "solo"}, "int8":
    {"mesh", "one"}, "one_row" / "fsdp": {"mesh", "one"}}``."""
    import torch
    from repro_torch import sharding
    from repro_torch.core import dfx
    from repro_torch.core.qconfig import QuantConfig
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig
    rec = _record_exponents(dfx)
    mesh = mesh_of((2, 2), ("data", "model"))
    cfg = _serve_cfg("qwen")
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    reqs = [(np.array(p), int(n), int(a)) for p, n, a in zip(
        inp["prompts"], inp["budgets"], inp["arrive"])]

    def run(q, m, requests):
        rec.clear()
        sharding.reset_stats()
        sharding.set_mesh(m)           # the engine reads it at its start
        try:
            eng = Engine(params, cfg, q, ServeConfig(max_seq=48,
                                                     batch_slots=4),
                         device="cpu")
        finally:
            sharding.set_mesh(None)
        return dict(runs=_batcher_run(eng, cfg, requests), exps=list(rec),
                    stats=dict(sharding.STATS))
    fp32, int8 = QuantConfig.fp32(), _rn_int8()
    # one prompt, which the data axis does not split: every rank holds the
    # row, the products still split over the model group
    one_row = {where: _serve_generate(cfg, params, int8, inp["prompts"][:1],
                                      3, m)
               for where, m in (("one", None), ("mesh", mesh))}
    # the rank's FSDP blocks (a trained model's layout) handed to the
    # engine: each layer gathered over data as it runs
    specs = sharding.param_pspecs(params, mesh, fsdp=True)
    fsdp = {"one": _serve_generate(cfg, params, int8, inp["prompts"][:4], 3,
                                   None),
            "mesh": _serve_generate(cfg, sharding.shard(params, specs, mesh),
                                    int8, inp["prompts"][:4], 3, mesh)}
    return {"fp32": {"mesh": run(fp32, mesh, reqs),
                     "solo": [run(fp32, None, [(p, n, 0)])
                              for p, n, _ in reqs]},
            "int8": {"mesh": run(int8, mesh, reqs),
                     "one": run(int8, None, reqs)},
            "one_row": one_row, "fsdp": fsdp}


def main(argv) -> int:
    import torch
    import torch.distributed as dist
    from repro_torch import sharding
    case, rank, world, port, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    os.environ["DIST_OUT"] = out_dir
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        inp = dict(np.load(os.path.join(out_dir, "in.npz")))
        out = globals()[f"case_{case}"](inp, sharding.init_mesh)
        torch.save(out, os.path.join(out_dir, f"out{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    sys.exit(main(sys.argv[1:]))
