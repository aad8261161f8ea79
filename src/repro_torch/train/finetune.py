"""Synthetic proxy tasks and the fine-tuning harness of the paper's
experiment: integer forward and backward through BERT and ViT, AdamW with
FP32 masters.

Counterpart of ``benchmarks/tasks.py``: the cls, span and img proxy
tasks, ``finetune``, the bit-width ``sweep`` and ``step_stats``.  The
samplers are numpy copies of the reference's, so both packages see the
same batches from the same seed.  GLUE/SQuAD/CIFAR data and pre-trained
weights are not in the repository: like the reference, the harness starts
from seeded random weights.

    PYTHONPATH=src python -c "from repro_torch.train.finetune import *; \\
        print(finetune('cls', paper_scope(), FtConfig(steps=8, batch=8, \\
        eval_n=32), device='cpu', return_losses=True))"
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.qconfig import QuantConfig
from repro_torch.core.qpolicy import QuantLike, QuantPolicy, ScopeRule
from repro_torch.kernels.ops import WRAPPERS
from repro_torch.models import paper_models as pm
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import resolve_device
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainer import loss_and_grads


def paper_scope(base: Optional[QuantConfig] = None) -> QuantPolicy:
    """The paper's integer scope: linear, layer-norm and embedding layers
    integer (``base``, default the int8 preset w8·a12·g8), attention's two
    products FP32 (the ``attn.qk`` leaf disabled)."""
    return QuantPolicy(base=base or QuantConfig.int8(),
                       rules=(ScopeRule("*.attn.qk", (("enabled", False),)),))


# ---------------------------------------------------------------------------
# task generators (numpy copies of the reference's)
# ---------------------------------------------------------------------------

def make_cls_task(vocab=512, seq=32, n_classes=4, seed=0):
    """GLUE proxy: class determined by which motif family dominates."""
    rng = np.random.default_rng(seed)
    motifs = rng.integers(0, vocab, size=(n_classes, 4, 6))

    def sample(n, seed2):
        r = np.random.default_rng((seed, seed2))
        y = r.integers(0, n_classes, n)
        toks = r.integers(0, vocab, (n, seq))
        for i in range(n):
            for _ in range(3):
                m = motifs[y[i], r.integers(0, 4)]
                pos = r.integers(0, seq - 6)
                toks[i, pos:pos + 6] = m
        return {"tokens": toks.astype(np.int32),
                "labels": y.astype(np.int32)}

    return sample


def make_span_task(vocab=512, seq=48, seed=0):
    """SQuAD proxy: an 'answer' span whose boundary tokens carry marker
    ids; the model predicts start/end positions."""
    START, END = vocab - 2, vocab - 1

    def sample(n, seed2):
        r = np.random.default_rng((seed, seed2))
        toks = r.integers(0, vocab - 2, (n, seq))
        s = r.integers(1, seq - 8, n)
        ln = r.integers(1, 6, n)
        e = s + ln
        for i in range(n):
            toks[i, s[i]] = START
            toks[i, e[i]] = END
        return {"tokens": toks.astype(np.int32),
                "span_start": s.astype(np.int32),
                "span_end": e.astype(np.int32)}

    return sample


def make_img_task(img=32, patch=8, n_classes=4, seed=0):
    """CIFAR proxy: class = quadrant of a bright blob on noise."""
    def sample(n, seed2):
        r = np.random.default_rng((seed, seed2))
        y = r.integers(0, n_classes, n)
        x = r.standard_normal((n, img, img, 3)).astype(np.float32) * 0.3
        half = img // 2
        for i in range(n):
            qy, qx = divmod(int(y[i]), 2)
            x[i, qy * half:(qy + 1) * half, qx * half:(qx + 1) * half] += 1.5
        return {"images": x, "labels": y.astype(np.int32)}

    return sample


# ---------------------------------------------------------------------------
# fine-tuning harness
# ---------------------------------------------------------------------------

#: the reference's learning rate of each task (bert-tiny's, vit-tiny's)
REFERENCE_LR = {"cls": 1e-3, "span": 2e-3, "img": 1e-3}


@dataclasses.dataclass
class FtConfig:
    steps: int = 150
    batch: int = 16
    eval_n: int = 256
    lr: Optional[float] = None  # None: the task's reference lr
    seed: int = 0
    seq: int = 0            # 0: the task's own length (cls 32, span 48)
    img: int = 0            # 0: the img task's own image side (32)


def vit_patch(cfg: ArchConfig, img: int) -> int:
    """The patch side of a ViT config at image side ``img`` (the config
    holds the patch count in its positions: patches + the class token)."""
    side = math.isqrt(cfg.max_position_embeddings - 1)
    if side * side + 1 != cfg.max_position_embeddings or img % side:
        raise ValueError(f"{cfg.name} does not tile {img}x{img} images")
    return img // side


def _task_setup(task: str, gen: torch.Generator, ft: FtConfig,
                arch: Optional[ArchConfig] = None, device="cpu"):
    """Model config / params / sampler / loss / lr for one proxy task: the
    reference's bert-tiny (vit-tiny for img), or ``arch`` with the samplers
    at its vocab (its patch, at image side ``ft.img``).  The lr is
    ``ft.lr``, or the task's reference lr when that is None."""
    if task == "img":
        cfg = arch or pm.vit_config(n_layers=4, d_model=128, n_heads=4,
                                    d_ff=256, img=32, patch=8,
                                    name="vit-tiny")
    else:
        cfg = arch or pm.bert_config(n_layers=4, d_model=128, n_heads=4,
                                     d_ff=256, vocab=512, name="bert-tiny")
    if task == "cls":
        params = pm.bert_init(gen, cfg, num_labels=4, device=device)
        sampler = make_cls_task(vocab=cfg.vocab, seq=ft.seq or 32)
        loss_fn = pm.bert_cls_loss
    elif task == "span":
        params = pm.bert_init(gen, cfg, span_head=True, device=device)
        sampler = make_span_task(vocab=cfg.vocab, seq=ft.seq or 48)
        loss_fn = pm.bert_span_loss
    elif task == "img":
        img = ft.img or 32
        patch = vit_patch(cfg, img)
        params = pm.vit_init(gen, cfg, num_classes=4, img=img, patch=patch,
                             device=device)
        sampler = make_img_task(img=img, patch=patch)
        loss_fn = functools.partial(pm.vit_cls_loss, patch=patch)
    else:
        raise KeyError(task)
    lr = ft.lr if ft.lr is not None else REFERENCE_LR[task]
    return cfg, params, sampler, loss_fn, lr


def to_device(batch: dict, device) -> dict:
    """A sampler's numpy batch on ``device``: integer arrays as int64
    tensors, images as float32."""
    return {k: torch.from_numpy(v).to(
        device=device,
        dtype=torch.float32 if v.dtype.kind == "f" else torch.int64)
        for k, v in batch.items()}


def train_step(params: dict, opt_state: opt_lib.OptState, batch: dict,
               cfg: ArchConfig, qcfg: QuantLike, loss_fn: Callable,
               opt_cfg: opt_lib.OptimizerConfig, key):
    """One step: loss and gradients of every parameter (integer forward and
    backward), then the AdamW update, in place.  A parameter the loss does
    not reach (the span task's classifier head) gets a zero gradient, as
    under ``jax.grad``.  Returns ``(params, opt_state, loss, grads,
    metrics)``: params and opt_state are the trees passed in, updated;
    grads are the unclipped gradients."""
    loss, _, grads = loss_and_grads(loss_fn, params, batch, cfg, qcfg, key)
    params, opt_state, metrics = opt_lib.update(opt_cfg, grads, opt_state,
                                                params)
    return params, opt_state, loss, grads, metrics


def evaluate(task: str, params: dict, cfg: ArchConfig, qcfg: QuantLike,
             sampler, n: int, device) -> float:
    """Accuracy (cls, img) or exact match of start and end (span), in %,
    on ``n`` held-out samples."""
    ev = to_device(sampler(n, 10_000_001), device)
    with torch.no_grad():
        if task == "img":
            patch = vit_patch(cfg, ev["images"].shape[1])
            logits = pm.vit_apply(params, ev["images"], cfg, qcfg, None,
                                  patch=patch)
            return 100 * float(torch.mean(
                (logits.argmax(-1) == ev["labels"]).float()))
        if task == "cls":
            logits = pm.bert_apply(params, ev["tokens"], cfg, qcfg, None)
            return 100 * float(torch.mean(
                (logits.argmax(-1) == ev["labels"]).float()))
        out = pm.bert_apply(params, ev["tokens"], cfg, qcfg, None,
                            pool=False)
        hit = ((out[..., 0].argmax(-1) == ev["span_start"])
               & (out[..., 1].argmax(-1) == ev["span_end"]))
        return 100 * float(torch.mean(hit.float()))


def finetune(task: str, qcfg: QuantLike, ft: FtConfig = FtConfig(), *,
             device="cuda", arch: Optional[ArchConfig] = None,
             return_losses: bool = False,
             on_step: Optional[Callable[[int, float], None]] = None):
    """Fine-tune the task's model under ``qcfg``; returns ``(metric,
    losses)`` (``losses`` None unless ``return_losses``).

    Params and the stochastic-rounding noise come from one
    ``torch.Generator`` on ``device`` seeded with ``ft.seed``.  ``arch``
    replaces the reference's bert-tiny (e.g. bert-base at full width).
    ``on_step(i, loss)`` is called after each step, the loss already on
    the host.
    """
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(ft.seed)
    cfg, params, sampler, loss_fn, lr = _task_setup(task, gen, ft, arch,
                                                    device)
    opt_cfg = opt_lib.OptimizerConfig(lr=lr, weight_decay=0.0)
    opt_state = opt_lib.init(params)
    losses = []
    for i in range(ft.steps):
        batch = to_device(sampler(ft.batch, i), device)
        params, opt_state, loss, _, _ = train_step(
            params, opt_state, batch, cfg, qcfg, loss_fn, opt_cfg, gen)
        losses.append(float(loss))
        if on_step is not None:
            on_step(i, losses[-1])
    metric = evaluate(task, params, cfg, qcfg, sampler, ft.eval_n, device)
    return (metric, losses) if return_losses else (metric, None)


def step_stats(task: str, qcfg: QuantLike, ft: FtConfig = FtConfig(),
               repeats: int = 3, *, device="cuda",
               arch: Optional[ArchConfig] = None) -> Dict:
    """Kernel launches and wall-clock of one training step.

    ``launches`` is the sum over every kernel wrapper of its ``.launches``
    across one step (``by_kernel`` by wrapper): the port's counterpart of
    the reference's ``pallas_calls``, the ``pallas_call`` equations traced
    into its jitted step.  The port runs eagerly and traces nothing, so it
    counts the launches themselves; like the traced count, it is the
    quantity the single-dispatch limb fusion makes bit-width-independent.
    Only CUDA launches count, so on the CPU (and under FP32) it is 0.
    ``step_us`` is the best of ``repeats`` synchronised steps after the
    counted one (the params move on between them; the time does not
    depend on their values)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(ft.seed)
    cfg, params, sampler, loss_fn, lr = _task_setup(task, gen, ft, arch,
                                                    device)
    opt_cfg = opt_lib.OptimizerConfig(lr=lr, weight_decay=0.0)
    opt_state = opt_lib.init(params)
    batch = to_device(sampler(ft.batch, 0), device)

    def step():
        nonlocal params, opt_state
        params, opt_state, loss, _, _ = train_step(
            params, opt_state, batch, cfg, qcfg, loss_fn, opt_cfg, gen)
        float(loss)                   # waits for the step's last kernel

    for w in WRAPPERS.values():
        w.launches = 0
    step()
    by_kernel = {n: w.launches for n, w in WRAPPERS.items()}
    best = float("inf")
    for _ in range(repeats):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return {"launches": sum(by_kernel.values()), "by_kernel": by_kernel,
            "step_us": best * 1e6}


def sweep(task: str, presets: List[str], ft: FtConfig = FtConfig(), *,
          device="cuda", arch: Optional[ArchConfig] = None
          ) -> Dict[str, float]:
    """``finetune`` under each config preset in turn: ``{preset:
    metric}``, one line printed per preset as the reference prints it."""
    out = {}
    for p in presets:
        t0 = time.time()
        metric, _ = finetune(task, QuantConfig.preset(p), ft, device=device,
                             arch=arch)
        out[p] = metric
        print(f"  {task:5s} {p:10s} metric={metric:6.2f} "
              f"({time.time() - t0:.0f}s)", flush=True)
    return out
