"""The work of one K5 splat on given particles, counted from its inputs
(frozen from the program's own count, which a later change may edit):

  bytes       x, y, size (float32), live (a byte) and the C colour floats
              of every particle read once, the (H, W, C) float32 image
              written once;
  operations  for each nonzero (particle, pixel) term the weight product
              and C products and sums, and for each nonzero footprint row
              and column of each live on-screen particle one profile
              (its operations counted as its plain form runs).

Taps of weight 0 and profiles recomputed per row are not the splat's
work and are not counted, so the count is the same whatever implements
the splat."""

import torch

from framebench.reference import image


def pointwise_ops(fn) -> int:
    """The elements written by fn()'s pointwise aten operations."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if torch.Tag.pointwise in func.tags:
                self.n += sum(t.numel() for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor))
            return out

    with Count() as count:
        fn()
    return count.n


def splat_work(cfg, x, y, color, size, live):
    """(bytes, operations) of one splat."""
    n, ch = x.shape[0], cfg["channels"]
    n_bytes = (n * (4.0 * 3 + 1.0 + 4.0 * ch)
               + 4.0 * cfg["height"] * cfg["width"] * ch)
    with torch.no_grad():
        sel, xs, ys, radius = image.selection(cfg, x, y, size, live)
        if sel.numel() == 0:
            return n_bytes, 0.0
        (_, wx), (_, wy) = image.footprints(cfg, xs, ys, radius)
        profiles = float((wx != 0.0).sum() + (wy != 0.0).sum())
        terms = float(sum(((wy[:, j:j + 1] * wx) != 0.0).sum()
                          for j in range(wy.shape[1])))
        one = torch.ones(1, device=x.device)
        per_profile = pointwise_ops(
            lambda: image.profile(cfg["kernel"], one * 0.3, one))
    return n_bytes, terms * (1 + 2 * ch) + profiles * per_profile
