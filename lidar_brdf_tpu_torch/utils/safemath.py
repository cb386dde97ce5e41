"""Gradient-safe elementary ops, value-preserving (counterpart of
`lidar_brdf_tpu/utils/safemath.py`).

Dense masked pipelines compute every slot and select with `torch.where`;
`0 * inf` is still NaN, so a |x|=1 arccos, a zero-vector normalize or a
sqrt(0) in a masked slot would poison a whole gradient.  These helpers keep
the forward value of the JAX package's versions and bound the derivative
elsewhere.  Sums over the 3-vector axis are written out left to right, the
order XLA's reduction uses, so both packages round alike.

Derivatives at ties follow JAX, not PyTorch: `jnp.clip` and `jnp.maximum`
give half the gradient to a value exactly at a bound (`torch.clamp` gives
all of it), and `jnp.abs` has derivative +1 at 0 (`torch.abs` has 0).
`clip`, `maximum` and `abs_` keep PyTorch's forward values bit for bit and
JAX's derivatives; the port uses them on every differentiated value where
the JAX package uses `jnp.clip`, `jnp.maximum` or `jnp.abs`.
"""

from __future__ import annotations

import torch


def dot3(a, b):
    """Sum over the last axis (length 3), evaluated ((a0b0 + a1b1) + a2b2)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a, b):
    """Cross product over the last axis, in `jnp.cross`'s operation order."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def maximum(x, lo: float):
    """`jnp.maximum(x, lo)`: half the gradient where x == lo."""
    return torch.maximum(x, x.new_full((), lo))


def minimum(x, hi: float):
    """`jnp.minimum(x, hi)`: half the gradient where x == hi."""
    return torch.minimum(x, x.new_full((), hi))


def clip(x, lo: float, hi: float):
    """`jnp.clip(x, lo, hi)`: half the gradient where x sits on a bound."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


class _Abs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs_(x):
    """`jnp.abs(x)`: derivative +1 at x = 0 (and at -0.0), -1 below."""
    return _Abs.apply(x)


def rsqrt(x):
    """1 / sqrt(x), both correctly rounded (the same value on every device,
    unlike the approximate `torch.rsqrt` on CUDA)."""
    return 1.0 / torch.sqrt(x)


def safe_norm(v, axis: int = -1, eps: float = 1e-24):
    """|v| over ``axis`` with a finite gradient at v = 0.  An axis of
    length 3 sums as `dot3` does, ((v0 v0 + v1 v1) + v2 v2)."""
    w = torch.movedim(v, axis, -1)
    s = dot3(w, w) if w.shape[-1] == 3 else (w * w).sum(dim=-1)
    return torch.sqrt(s + eps)


def safe_unit(v, eps: float = 1e-24):
    """v / |v| with a finite gradient at v = 0 (returns ~0 there)."""
    n2 = dot3(v, v)[..., None]
    return v * rsqrt(maximum(n2, eps))


def safe_arccos(x, eps: float = 1e-6):
    """arccos(clip(x, -1, 1)) with the gradient of the clipped-inward
    evaluation (bounded at |x| = 1)."""
    xc = clip(x, -1.0, 1.0)
    ag = torch.arccos(clip(xc, -1.0 + eps, 1.0 - eps))
    return ag + (torch.arccos(xc) - ag).detach()


def safe_arctan2(y, x, eps: float = 1e-12):
    """atan2(y, x) with the gradient redirected away from y = x = 0."""
    ok = (y * y + x * x) > eps
    ag = torch.atan2(torch.where(ok, y, torch.zeros_like(y)),
                     torch.where(ok, x, torch.ones_like(x)))
    return ag + (torch.atan2(y, x) - ag).detach()


def safe_sqrt(x, eps: float = 1e-24):
    """sqrt(max(x, 0)) with a finite gradient at x <= 0."""
    ok = x > eps
    val = torch.sqrt(torch.where(ok, x, torch.ones_like(x)))
    return torch.where(ok, val, torch.zeros_like(val))
