"""Synthetic proxy tasks and the fine-tuning harness of the paper's
experiment: integer forward and backward through BERT, AdamW with FP32
masters.

Counterpart of ``benchmarks/tasks.py`` (the cls and span tasks and
``finetune``; the image task waits for ViT).  The samplers are numpy
copies of the reference's, so both packages see the same batches from the
same seed.  GLUE/SQuAD data and pre-trained weights are not in the
repository: like the reference, the harness starts from seeded random
weights.

    PYTHONPATH=src python -c "from repro_torch.train.finetune import *; \\
        print(finetune('cls', paper_scope(), FtConfig(steps=8, batch=8, \\
        eval_n=32), device='cpu', return_losses=True))"
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.qconfig import QuantConfig
from repro_torch.core.qpolicy import QuantLike, QuantPolicy, ScopeRule
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


# ---------------------------------------------------------------------------
# fine-tuning harness
# ---------------------------------------------------------------------------

#: the reference's learning rate of each task (bert-tiny's)
REFERENCE_LR = {"cls": 1e-3, "span": 2e-3}


@dataclasses.dataclass
class FtConfig:
    steps: int = 150
    batch: int = 16
    eval_n: int = 256
    lr: Optional[float] = None  # None: the task's reference lr
    seed: int = 0
    seq: int = 0            # 0: the task's own length (cls 32, span 48)


def _task_setup(task: str, gen: torch.Generator, ft: FtConfig,
                arch: Optional[ArchConfig] = None, device="cpu"):
    """Model config / params / sampler / loss / lr for one proxy task: the
    reference's bert-tiny, or ``arch`` with the samplers at its vocab.
    The lr is ``ft.lr``, or the task's reference lr when that is None."""
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
        raise NotImplementedError("the img task needs ViT, not ported yet")
    else:
        raise KeyError(task)
    lr = ft.lr if ft.lr is not None else REFERENCE_LR[task]
    return cfg, params, sampler, loss_fn, lr


def to_device(batch: dict, device) -> dict:
    """A sampler's numpy batch as int64 tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.int64)
            for k, v in batch.items()}


def train_step(params: dict, opt_state: opt_lib.OptState, batch: dict,
               cfg: ArchConfig, qcfg: QuantLike, loss_fn: Callable,
               opt_cfg: opt_lib.OptimizerConfig, key):
    """One step: loss and gradients of every parameter (integer forward and
    backward), then the AdamW update.  A parameter the loss does not reach
    (the span task's classifier head) gets a zero gradient, as under
    ``jax.grad``.  Returns ``(params, opt_state, loss, grads, metrics)``."""
    loss, _, grads = loss_and_grads(loss_fn, params, batch, cfg, qcfg, key)
    new_params, opt_state, metrics = opt_lib.update(opt_cfg, grads,
                                                    opt_state, params)
    return new_params, opt_state, loss, grads, metrics


def evaluate(task: str, params: dict, cfg: ArchConfig, qcfg: QuantLike,
             sampler, n: int, device) -> float:
    """Accuracy (cls) or exact match of start and end (span), in %, on
    ``n`` held-out samples."""
    ev = to_device(sampler(n, 10_000_001), device)
    with torch.no_grad():
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
