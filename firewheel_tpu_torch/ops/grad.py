"""The kernels with no backward: K1 (``ops/seq_iir.py``), K2 and K3 (the
megakernel's entries) refuse a gradient, as ``jax.grad`` through the JAX
package's ``pallas_call`` raises."""

from __future__ import annotations

import torch

__all__ = ["refuse_gradients"]


def refuse_gradients(who: str, *trees) -> None:
    """Raise ``NotImplementedError`` when autograd records (grad mode on) and
    a tensor leaf of ``trees`` requires a gradient: ``who`` is a kernel with
    no backward, as the JAX package's ``pallas_call`` has no transpose
    rule and ``jax.grad`` through it raises.  Checked on every device."""
    if not torch.is_grad_enabled():
        return
    found = []

    def visit(t):
        if isinstance(t, dict):
            for v in t.values():
                visit(v)
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            found.append(t)

    for tree in trees:
        visit(tree)
    if found:
        raise NotImplementedError(
            f"{who} has no backward (the JAX package's Pallas kernel has none either): "
            "differentiate the eager path (FilterNode's 'auto' backend; ScheduleProgram, "
            "BatchRenderer with the default lowering), or render under torch.no_grad()")
