"""The activation-checkpoint policy of the per-layer remat.

Counterpart of the policy part of ``repro/utils.py``:
``CHECKPOINT_POLICY`` picks what ``models/lm.py::_remat`` keeps of a
layer between its forward and its backward.

* ``None`` / ``"nothing"`` — full remat: the layer's input alone; the
  backward recomputes the rest (the default).
* ``"dots"`` — also the outputs of the layer's FP32 2-D products
  (``aten.mm``, ``aten.addmm``), the counterpart of JAX's
  ``dots_with_no_batch_dims_saveable``: an FP32 linear layer's output is
  kept, a batched product (``aten.bmm``: the FP32 attention's einsums,
  ``blocks.flash_attention``; the MoE experts') never.  An integer
  product is a kernel wrapper, not an FP32 ``aten.mm`` (its plain version
  multiplies in float64), so it is never kept: under an integer config
  ``"dots"`` keeps what full remat keeps, as the reference's policy does
  on its Pallas route, where the integer products are ``pallas_call``s.

The remat sites are ``lm._remat``'s callers (the dense, MoE, VLM, SSM and
hybrid stacks, the BERT / ViT encoder of ``models/paper_models.py``) and
``encdec._remat_call`` (whisper's two stacks).

Not ported (the port's layer loops are Python loops): ``scan`` and its
``ANALYSIS_UNROLL`` switch, ``analysis_unroll``, ``count_eqns`` and
``count_pallas_calls`` (the port counts each kernel wrapper's calls).
"""
from __future__ import annotations

import functools
from typing import List, Optional

import torch

#: activation-checkpoint policy of the per-layer remat: None (full
#: remat), ``"dots"`` (keep the FP32 2-D products' outputs) or
#: ``"nothing"`` (an alias of full remat)
CHECKPOINT_POLICY: Optional[str] = None

POLICIES = (None, "nothing", "dots")

#: the FP32 2-D products ``"dots"`` keeps
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

#: when a list: each output ``"dots"`` keeps in a forward is appended as
#: ``(op name, shape, dtype)`` (tests read what the policy kept)
RECORD: Optional[List[tuple]] = None


def _dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if op not in _SAVED_OPS:
        return CheckpointPolicy.PREFER_RECOMPUTE
    a, b = args[-2:]                 # mm(a, b), addmm(bias, a, b)
    if a.dtype != torch.float32:
        return CheckpointPolicy.PREFER_RECOMPUTE
    if RECORD is not None and not ctx.is_recompute:
        RECORD.append((op.overloadpacket.__name__, (a.shape[0], b.shape[1]),
                       a.dtype))
    return CheckpointPolicy.MUST_SAVE


def checkpoint_context():
    """The ``context_fn`` ``torch.utils.checkpoint.checkpoint`` takes under
    ``CHECKPOINT_POLICY`` (None: full remat, the checkpoint's default)."""
    if CHECKPOINT_POLICY not in POLICIES:
        raise ValueError(f"CHECKPOINT_POLICY {CHECKPOINT_POLICY!r}: one of "
                         f"{POLICIES}")
    if CHECKPOINT_POLICY != "dots":
        return None
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return functools.partial(create_selective_checkpoint_contexts, _dots)
