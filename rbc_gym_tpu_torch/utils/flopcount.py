"""Counted FLOP of a PyTorch function, op by op (a dispatch-mode walk).

Twin of ``rbc_gym_tpu/utils/flopcount.py``. The JAX module walks a
jaxpr; here ``count_fn_flops`` runs the function under a
``TorchDispatchMode`` and counts every aten op it reaches, on whatever
device the inputs live. It counts the plain PyTorch paths (the twins of
the JAX package's XLA paths) and the PyTorch parts of a kernel path,
such as the 3D Poisson GEMMs (``ops/poisson.make_poisson_solver_3d``).

It cannot see into a hand kernel: a ctypes launch is no aten op. So a
count during which any kernel wrapper's ``.launches`` counter moves
(``ops/registry.py``: ``env_step_2d``, ``tendencies_2d``, ``stage_rk_3d``,
``stage_rk_3d_xy``, ``correct_3d``, ``field_tendency_3d``, ``div_3d``) raises ``ValueError`` naming the
kernels, rather than count their work as zero. The kernels' own work is
counted from their sources in ``utils/roofline.py``.

Counting conventions (the JAX module's, mapped to aten):

* arithmetic (add, sub, mul, div, neg, abs, maximum, minimum, pow, exp,
  log, sqrt, rsqrt, reciprocal, sign, floor, ceil, round, remainder,
  trig, tanh): 1 FLOP per output element, so an FMA counts 2;
* a fused aten op counts as its parts: ``addcmul`` and ``addcdiv`` 2 (3
  with ``value != 1``), ``lerp`` 3, ``add``, ``sub`` and ``rsub`` with
  ``alpha != 1`` 2;
* in-place (``add_``) and ``out=`` forms count as their out-of-place forms;
* ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and ``matmul``: 2*M*N*K, under
  "gemm" (the JAX module's "mxu");
* ``sum``, ``cumsum``, ``amax``, ``amin``, ``prod`` and the reducing forms
  of ``max`` and ``min``: 1 per input element; ``mean`` as its sum and
  one division per output element (the JAX mean's reduce_sum and div);
* selects, ``clamp``, comparisons, views, copies, ``cat``, padding,
  ``flip``, ``roll``, indexing, casts, fills and random draws: 0.

Any other op goes into ``unknown_ops``; it is never dropped silently.
Counts depend on shapes only: the plain paths take no data-dependent
branch.
"""

from __future__ import annotations

from typing import Any, Dict

from torch.utils._python_dispatch import TorchDispatchMode

from rbc_gym_tpu_torch.ops.registry import kernel_launches

_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "maximum", "minimum", "fmax", "fmin",
    "pow", "exp", "log", "sqrt", "rsqrt", "reciprocal", "sign", "floor", "ceil", "round",
    "trunc", "remainder", "fmod", "sin", "cos", "tan", "asin", "acos", "atan", "atan2",
    "sinh", "cosh", "tanh",
}
_GEMM = {"mm", "bmm", "addmm", "baddbmm", "matmul"}
_REDUCTIONS = {"sum", "cumsum", "amax", "amin", "prod"}
_ZERO_COST = {
    # selects, clamps, comparisons
    "where", "clamp", "clamp_min", "clamp_max", "clip", "gt", "lt", "ge", "le", "eq", "ne",
    "isfinite", "isnan", "isinf", "logical_not", "any", "all",
    # views
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "expand_as", "view_as",
    "broadcast_to", "slice", "select", "narrow", "permute", "transpose", "t", "unsqueeze",
    "squeeze", "as_strided", "alias", "detach", "diagonal", "unbind", "split",
    "split_with_sizes", "chunk", "movedim", "unfold", "lift_fresh",
    # copies, casts, concatenation, padding, reordering, indexing
    "clone", "copy", "_to_copy", "to", "contiguous", "cat", "stack", "constant_pad_nd",
    "pad", "flip", "roll", "repeat", "index", "index_select", "gather", "scatter",
    "index_put", "masked_fill", "_local_scalar_dense",
    # allocation, fills, random draws
    "empty", "empty_like", "empty_strided", "zeros", "zeros_like", "ones", "ones_like",
    "full", "full_like", "fill", "zero", "new_empty", "new_zeros", "new_ones", "new_full",
    "scalar_tensor", "arange", "linspace", "randn", "rand", "normal", "uniform", "randint",
    "resize", "set",
}


def _out_elems(out) -> int:
    if isinstance(out, (tuple, list)):
        out = out[0]
    return out.numel()


def _scalar(args, kwargs, key: str, index: int, default=1):
    if key in kwargs:
        return kwargs[key]
    return args[index] if len(args) > index else default


def _count(func, args, kwargs, out, counts: Dict[str, Any]) -> None:
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]  # in-place form
    if name in ("max", "min"):  # binary form elementwise, the others reduce
        name = ("maximum" if name == "max" else "minimum") if (
            len(args) > 1 and hasattr(args[1], "shape")) else "amax"
    if name in _ELEMENTWISE:
        flops = 1
        if name in ("add", "sub", "rsub") and _scalar(args, kwargs, "alpha", 2) != 1:
            flops = 2
        counts["elementwise"] += flops * _out_elems(out)
    elif name in ("addcmul", "addcdiv"):
        flops = 2 + (_scalar(args, kwargs, "value", 3) != 1)
        counts["elementwise"] += flops * _out_elems(out)
    elif name == "lerp":
        counts["elementwise"] += 3 * _out_elems(out)
    elif name in _GEMM:
        a = args[1] if name in ("addmm", "baddbmm") else args[0]
        counts["gemm"] += 2.0 * _out_elems(out) * a.shape[-1]
    elif name in _REDUCTIONS:
        counts["elementwise"] += args[0].numel()
    elif name == "mean":  # its sum, then one division per output element
        counts["elementwise"] += args[0].numel() + _out_elems(out)
    elif name not in _ZERO_COST:
        counts["unknown_ops"].add(f"aten.{func.overloadpacket.__name__}")


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts: Dict[str, Any] = {"elementwise": 0.0, "gemm": 0.0, "unknown_ops": set()}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        _count(func, args, kwargs, out, self.counts)
        return out


def count_fn_flops(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and return ``{"elementwise": FLOP,
    "gemm": FLOP, "unknown_ops": set of aten op names}``. Raises
    ``ValueError`` naming the kernels if a hand kernel launched meanwhile."""
    before = kernel_launches()
    with _Counter() as counter:
        fn(*args, **kwargs)
    moved = [name for name, n in kernel_launches().items() if n != before[name]]
    if moved:
        raise ValueError(
            f"hand kernels launched during the count: {', '.join(moved)}; their work is "
            "invisible to a dispatch mode and would count as zero (count the plain path, "
            "or take the kernels' work from utils.roofline)")
    return counter.counts
