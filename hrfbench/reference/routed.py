"""The reference's field routed per segment, for models of many segments.

`humanrf.HumanRFModel.features` runs every segment's lookups over all N
samples and masks the samples of the other segments, so what its backward
keeps grows as segments × N: at the 1000-frame configuration's 20 segments
and 640,000 slots, about 4 GB of corner indices and weights a segment.
`RoutedHumanRFModel` gathers each segment's served samples (below
`n_valid`, of that segment), runs `fused_field.field_lookups` over them
alone and scatters the lookups back into zeros; the sum over segments and
the composition are the masked model's. Each sample gets the same lookups,
computed in the same order, and the masked sum's other terms are exact
zeros, so the features equal the masked model's bit for bit, and so do the
tables' gradients where the scatter-adds run in order (the CPU): each entry
takes the same non-zero terms in the same order.

`installed()` puts the routed model into the reference's training check
(`check.train_steps`) and `train_numbers` in place of `check.train_numbers`
for a `with` block, and records there which segments the reference's
differentiated queries serve: the training loop's driver
(`drivers/train_loop_routed.py`) and the control (`control_routed.py`) run
`train_loop` inside it.
"""
from __future__ import annotations

import contextlib
import statistics
from typing import Dict, Mapping, Optional

import torch

from hrfbench.reference import check
from hrfbench.reference.fused_field import compose
from hrfbench.reference.humanrf import HumanRFModel

masked_train_numbers = check.train_numbers


class RoutedHumanRFModel(HumanRFModel):
    """`HumanRFModel` whose `features` route each segment's lookups over its
    own samples. `served`, where `installed()` sets it, collects the
    segments that a differentiated query served samples of."""

    served: Optional[set] = None

    def features(self, positions: torch.Tensor, frame_numbers: torch.Tensor,
                 tables: Optional[Mapping[int, torch.Tensor]] = None,
                 n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """As `HumanRFModel.features`, routed (see the module docstring)."""
        tables = tables or {}
        frame_numbers = frame_numbers.long()
        times = self.frame_to_local_time[frame_numbers][:, None]
        xyz = positions + 0.5
        n = xyz.shape[0]
        live = torch.ones(n, dtype=torch.bool, device=xyz.device)
        if n_valid is not None:
            live = torch.arange(n, device=xyz.device) < n_valid.reshape(())
        seg = self._segment_ids(frame_numbers)
        shape = (4, self.config.total_feature_dim, n)
        grid, vectors = xyz.new_zeros(shape), xyz.new_zeros(shape)
        for s, segment in enumerate(self.segments):
            idx = torch.nonzero(live if seg is None else live & (seg == s)).squeeze(1)
            if self.served is not None and torch.is_grad_enabled() and idx.numel():
                self.served.add(s)
            f, v = segment.lookups(xyz[idx], times[idx], tables.get(s))
            grid, vectors = grid.index_add(2, idx, f), vectors.index_add(2, idx, v)
        return compose(grid, vectors)


def _leaves(tree: Dict[str, torch.Tensor], names) -> Dict[str, torch.Tensor]:
    return {n: tree[n] for n in names}


def _segment(leaf: str) -> Optional[int]:
    parts = leaf.split(".")
    return int(parts[1]) if parts[0] == "segments" else None


def train_numbers(program: dict, reference: dict, initial: Dict[str, torch.Tensor]) -> tuple:
    """`check.train_numbers`, split by what the steps reached. A step's rays
    come from at most `max_num_frames_per_batch` frames, so the tables of
    the segments they miss take no gradient, and where those are most of
    the leaves the median leaf's gradient norm, `check`'s measure of each
    gap, is nought. So:

    - `loss_gap` and `grad_gap` are `check`'s over the leaves whose
      reference gradient at step 1 is not all zero;
    - `median_update_gap` is `check`'s measure over the leaves reached at
      any check step (step 1's, and the tables of the segments that the
      reference's queries served: `RoutedHumanRFModel.served`);
    - `stray_grad`: the largest |entry| of the program's step-1 gradient in
      the leaves whose reference gradient is all zero (a backward that
      scatters into a segment no sample of the step lies in);
    - `unreached_update_gap`: over the leaves no check step reached, the
      worst ‖program's change − reference's‖ / ‖reference's change‖ of the
      parameters. Their change is weight decay alone, the same arithmetic
      on both sides (an optimizer that skips such leaves reads 1).
    """
    grads = reference["grads"]
    step1 = [n for n, g in grads.items() if bool(g.any())]
    served = RoutedHumanRFModel.served or set()
    reached = [n for n in grads if n in step1 or _segment(n) in served]
    unreached = [n for n in grads if n not in reached]
    pick = lambda run: dict(run, grads=_leaves(run["grads"], step1), params=_leaves(run["params"], step1))  # noqa: E731
    numbers, worst = masked_train_numbers(pick(program), pick(reference), _leaves(initial, step1))
    change = lambda params, leaves: {n: params[n] - initial[n] for n in leaves}  # noqa: E731
    update = check.leaf_gaps(change(program["params"], reached), change(reference["params"], reached), reached)
    numbers["median_update_gap"] = statistics.median(update.values())
    worst.update(update_leaf=max(update, key=update.get), worst_update_gap=max(update.values()))
    numbers["stray_grad"] = max((float(program["grads"][n].abs().max()) for n in grads if n not in step1), default=0.0)
    gaps = {}
    for n in unreached:
        ours, theirs = program["params"][n] - initial[n], reference["params"][n] - initial[n]
        miss, scale = float((ours.double() - theirs.double()).norm()), float(theirs.double().norm())
        gaps[n] = miss / scale if scale else (0.0 if miss == 0 else float("inf"))
    numbers["unreached_update_gap"] = max(gaps.values(), default=0.0)
    worst["unreached_leaf"] = max(gaps, key=gaps.get) if gaps else None
    return numbers, worst


@contextlib.contextmanager
def installed():
    """The routed model and `train_numbers` in `check` for the block, and a
    fresh record of the segments the reference serves."""
    saved = check.HumanRFModel, check.train_numbers, RoutedHumanRFModel.served
    check.HumanRFModel, check.train_numbers = RoutedHumanRFModel, train_numbers
    RoutedHumanRFModel.served = set()
    try:
        yield
    finally:
        check.HumanRFModel, check.train_numbers, RoutedHumanRFModel.served = saved
