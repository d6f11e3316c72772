"""A prefix sum whose bits do not depend on timing.

A 1-D ``torch.cumsum`` of a CUDA tensor (and ``torch.multinomial``'s prefix
sum with it) runs CUB's decoupled look-back scan, which associates its adds
by the order in which blocks finish: past about 10^5 elements its bits vary
from run to run. A scan along the rows of a 2-D tensor does not, and a
``cumsum`` along the first axis of a tall, narrow tensor runs one thread per
column. :func:`prefix_sum` scans rows of a fixed width, then the rows'
totals the same way, so its order is fixed by the length alone and every
row of work runs in parallel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["prefix_sum"]


def prefix_sum(x: torch.Tensor, width: int = 1024) -> torch.Tensor:
    """Inclusive prefix sum along the last axis of ``x [..., n]``."""
    n = x.shape[-1]
    rows = -(-n // width)
    # two rows at least: a tensor of one row takes the 1-D scan
    blocks = F.pad(x, (0, max(rows, 2) * width - n)).unflatten(-1, (-1, width)).cumsum(-1)
    if rows > 1:
        totals = prefix_sum(blocks[..., :rows, -1], width)
        blocks[..., 1:rows, :] += totals[..., : rows - 1, None]
    return blocks.flatten(-2)[..., :n]
