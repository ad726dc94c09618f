"""The numbers that decide ``correct``, each against its limit.

Training (the first steps of the object the window then drives, against
the plain reference following the same steps):
  * ``loss_gap``: the worst step's |loss - reference loss| / |reference loss|.
  * ``grad_gap``: the first gradient as Adam got it (its first moment after
    one step, divided by 1 - beta1), by the worst leaf: the gap between the
    program's norm and the reference's, over the larger of that leaf's
    reference norm and the median leaf's.
  * ``change_gap``: the parameters' change over the checked steps, by the
    worst leaf, measured the same way. Leaves whose reference gradient is
    under a thousandth of the median leaf's at every step move by round-off
    alone and are left out.
Serving:
  * ``mask_gap``: the widest |served mask - reference mask| over a sample,
    drawn from the seed, of the requests the window finished.
"""

from __future__ import annotations

import math

import torch

EXCLUDE_BELOW = 1e-3  # of the median leaf's reference gradient
FAR = 1e300  # printed for a number that is not finite (JSON has no infinity)


def _median(xs):
    s = sorted(xs)
    n = len(s)
    return 0.0 if not n else (s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2]))


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: |prog - ref| / max(ref, median ref)}, for {leaf: norm} maps."""
    names = [k for k in ref if keep is None or k in keep]
    med = _median([ref[k] for k in names])
    out = {}
    for k in names:
        scale = max(ref[k], med)
        if scale > 0.0:
            gap = abs(prog.get(k, 0.0) - ref[k]) / scale
            out[k] = gap if math.isfinite(gap) else math.inf
    return out


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    return max(leaf_gaps(prog, ref, keep).values(), default=0.0)


def moved_leaves(ref_grad_norms: list) -> set:
    """The leaves whose reference gradient reaches a thousandth of the
    median leaf's at some step; ``ref_grad_norms`` is one {leaf: norm} a step."""
    keep = set()
    for step in ref_grad_norms:
        med = _median(list(step.values()))
        keep |= {k for k, v in step.items() if v >= EXCLUDE_BELOW * med and v > 0}
    return keep


def train_numbers(prog: dict, ref: dict) -> dict:
    """The three training numbers from the two sides' readings: each side
    gives ``losses`` (a list), ``grad1`` and ``change`` ({leaf: norm}); the
    reference also ``grad_steps`` (its {leaf: norm} at every step)."""
    losses = [abs(a - b) / abs(b) if b else math.inf for a, b in zip(prog["losses"], ref["losses"])]
    loss_gap = max(losses) if all(math.isfinite(x) for x in prog["losses"]) else math.inf
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(prog["grad1"], ref["grad1"]),
            "change_gap": leaf_gap(prog["change"], ref["change"], moved_leaves(ref["grad_steps"]))}


def mask_gap(served: list, reference: list) -> float:
    """max |a - b| over matching (N, H, W) arrays; a missing or
    non-finite answer reads infinite."""
    worst = 0.0
    for a, b in zip(served, reference):
        a, b = torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(b, dtype=torch.float32)
        if a.shape != b.shape or not torch.isfinite(a).all():
            return math.inf
        worst = max(worst, float((a - b).abs().max()))
    return worst


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    ok = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
    return ok, {k: {"value": numbers[k] if math.isfinite(numbers[k]) else FAR, "limit": limits[k]} for k in limits}


def leaf_norms(tensors: dict) -> dict:
    """{leaf: float norm}, read back in one transfer."""
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([tensors[k].detach().float().norm() for k in names]).cpu().tolist()
    return dict(zip(names, norms))
