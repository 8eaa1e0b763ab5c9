"""Named spans at the port's layer boundaries, for ``torch.profiler``.

``span(name)`` opens ``record_function("repro_torch::<name>")`` around a
layer's forward. ``mark_backward(name, x, y)`` brackets the same layer's
backward pass, which autograd runs after the forward has returned (on its
own thread on the card), in ``repro_torch::<name>.backward``: a gradient
hook on the layer's output opens it, one on its input closes it. Both act
only while a profiler is collecting: otherwise a span costs one check of
the profiler's flag and ``mark_backward`` returns ``y`` untouched. A hook
is no autograd node, so neither changes a value, a dtype, a stride, the
graph or the tensors autograd saves (non-reentrant checkpoint's recompute
saves as many as the forward did; the hooks it sets on its recomputed
tensors never fire, since no gradient flows through them).

The spans stay in the profiler's memory and come out with its trace, on
the clock of its device events: the innermost span open at a kernel's
launch call names the layer that launched it.

    with spans.span("attention"):
        ...
        return spans.mark_backward("attention", x, out)
"""
from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

PREFIX = "repro_torch::"
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``repro_torch::<name>`` while a profiler is
    collecting, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def mark_backward(name: str, x: torch.Tensor, y: torch.Tensor):
    """Returns ``y``, the output of a layer whose input was ``x``. While a
    profiler collects, grad is enabled and both require grad, the backward
    pass records ``repro_torch::<name>.backward`` from the moment ``y``'s
    gradient is complete to the moment ``x``'s is: ``x`` must feed only
    this layer, and reach what the backward pass differentiates for."""
    if not (_profiler._is_profiler_enabled and torch.is_grad_enabled()
            and x.requires_grad and y.requires_grad):
        return y
    label, held = f"{PREFIX}{name}.backward", []

    def begin(grad):
        held.append(torch.ops.profiler._record_function_enter_new(label,
                                                                 None))

    def end(grad):
        if held:
            with torch._C.DisableTorchFunctionSubclass():
                torch.ops.profiler._record_function_exit._RecordFunction(
                    held.pop())

    y.register_hook(begin)
    x.register_hook(end)
    return y
