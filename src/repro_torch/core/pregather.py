"""Pre-gathering's shape-budget signal.

Only :class:`PlanOverflow` is here so far: the serving planner raises it.
The gather plan itself (``build_gather_plan``, ``SlotMap``) arrives with
the training slice.
"""
from __future__ import annotations


class PlanOverflow(ValueError):
    """A rectangular plan array would not fit the requested shape budget.

    Carries which budgeted dimension overflowed (``"batch_pad"`` or
    ``"r_max"``) and the size actually needed, so callers (the ShapeBudget)
    can re-bucket precisely instead of parsing messages.
    """

    def __init__(self, field: str, needed: int, limit: int):
        super().__init__(f"{field} overflow: need {needed} > {field}={limit}")
        self.field = field
        self.needed = int(needed)
        self.limit = int(limit)
