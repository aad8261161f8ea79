"""DFX-compressed cross-pod gradient all-reduce with error feedback.

Counterpart of ``repro/core/grad_compress.py``.  The paper quantizes the
local gradient tensors; the reference carries its mapping to the
collective over the ``pod`` axis:

  1. each pod computes its local gradient (mean-reduced over ``data``),
  2. the shared scale is synced with a MAX all-reduce of the int32 step
     exponent,
  3. the gradient is quantized against it (``qtensor.quantize(exp=)``,
     one ``dfx_quantize`` launch on the card) and the logical int32
     mantissas are SUM all-reduced (exact),
  4. the estimate is that sum times the scale over the pod count, and the
     quantization error is carried into the next step's gradient
     (error feedback: the compression is unbiased over time).

The group is any process group (``sharding.Mesh.group("pod")``).  The
sum runs over the recombined int32 mantissa, as the reference's ``psum``
does: its payload is 4 bytes an element.  Each rank quantizes with its
own tensor's exponent first (``sharding.manual_axes_active``: the
reference's ``shard_map`` body).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import sharding
from repro_torch.core import dfx, qtensor
from repro_torch.train import optimizer as opt_lib


def _compress_leaf(g: torch.Tensor, residual: Optional[torch.Tensor],
                   bits: int, axis: str, mesh: sharding.Mesh,
                   npods: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized mean all-reduce of one gradient leaf along ``axis`` with
    error feedback: (the estimate, the new residual)."""
    g32 = g.to(torch.float32)
    if residual is not None:
        g32 = g32 + residual
    exp = sharding.all_reduce(qtensor.step_exponent(g32, bits), "max", axis,
                              mesh, tag="compress_exp")
    t = qtensor.quantize(g32, bits, exp=exp)
    new_residual = g32 - qtensor.dequantize(t)
    # exact for <= 2^(31 - b - log2(npods)) pods
    summed = sharding.all_reduce(qtensor.int_mantissa(t), "sum", axis, mesh,
                                 tag="compress_sum")
    out = summed.to(torch.float32) * dfx.pow2(exp) / npods
    return out, new_residual


def compressed_psum_mean(grads: Any, residuals: Optional[Any], *,
                         bits: int = 8, axis: str = "pod",
                         min_size: int = 65536,
                         mesh: Optional[sharding.Mesh] = None
                         ) -> Tuple[Any, Any]:
    """Tree-wise compressed mean all-reduce along a mesh axis (``mesh``:
    the active one by default).  Leaves smaller than ``min_size`` elements
    take a plain FP32 SUM all-reduce over the pod count (scales, norms and
    biases are latency-bound) and a zero residual.  ``residuals`` None: no
    error feedback this step."""
    flat = opt_lib.tree_leaves(grads)
    if residuals is None:
        res_flat = [None] * len(flat)
    else:
        try:
            opt_lib.tree_map(lambda *_: None, grads, residuals)
        except ValueError as e:
            # pairing residuals with the wrong leaves would corrupt the
            # error feedback
            raise ValueError(
                f"residual tree does not match the gradient tree ({e}); "
                "build residuals with init_residuals(params)") from None
        res_flat = opt_lib.tree_leaves(residuals)
    mesh = mesh or sharding.get_mesh()
    npods = mesh.count(axis)
    out, new_res = [], []
    with sharding.manual_axes_active(mesh.axis_names):
        for g, r in zip(flat, res_flat):
            if g.numel() < min_size:
                out.append(sharding.all_reduce(
                    g.to(torch.float32), "sum", axis, mesh,
                    tag="compress_fp32") / npods)
                new_res.append(torch.zeros_like(g, dtype=torch.float32))
            else:
                o, nr = _compress_leaf(g, r, bits, axis, mesh, npods)
                out.append(o)
                new_res.append(nr)
    return (opt_lib.tree_unflatten(grads, out),
            opt_lib.tree_unflatten(grads, new_res))


def init_residuals(params: Any) -> Any:
    return opt_lib.tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params)
