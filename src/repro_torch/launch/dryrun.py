"""Dry-run machinery of the port: where records go, and the census of
collective bytes.

The reference lowers and compiles its programs for a pod mesh on
placeholder host devices and reads the collectives from the optimized HLO
(``repro.launch.dryrun.collective_bytes``). The port runs its programs
eagerly, so its census watches them run: :class:`CollectiveCensus` is a
``TorchDispatchMode`` that sees every c10d collective a call issues (the
``torch.distributed`` ops and the functional collectives) and sums, per
op, the bytes of its output on this rank. An op executed T times is
counted T times; the reference's HLO lists an op inside a ``scan`` body
once.

Records are written under ``build/dryrun_torch/`` at the root of the
checkout (git-ignored), never under ``benchmarks/``.
"""
from __future__ import annotations

from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"

# qualified op name -> (the reference's HLO op name, where the output is:
# "arg" = the op's first argument, written in place; "ret" = its result)
_COLLECTIVES = {
    "c10d::alltoall_base_": ("all-to-all", "arg"),
    "c10d::alltoall_": ("all-to-all", "arg"),
    "c10d::allreduce_": ("all-reduce", "arg"),
    "c10d::allreduce_coalesced_": ("all-reduce", "arg"),
    "c10d::allgather_": ("all-gather", "arg"),
    "c10d::_allgather_base_": ("all-gather", "arg"),
    "c10d::allgather_coalesced_": ("all-gather", "arg"),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", "arg"),
    "c10d::reduce_scatter_": ("reduce-scatter", "arg"),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", "arg"),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", "arg"),
    "_c10d_functional::all_to_all_single": ("all-to-all", "ret"),
    "_c10d_functional::all_reduce": ("all-reduce", "ret"),
    "_c10d_functional::all_reduce_": ("all-reduce", "ret"),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", "ret"),
    "_c10d_functional::all_reduce_coalesced_": ("all-reduce", "ret"),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", "ret"),
    "_c10d_functional::all_gather_into_tensor_out": ("all-gather", "ret"),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather",
                                                           "ret"),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", "ret"),
    "_c10d_functional::reduce_scatter_tensor_out": ("reduce-scatter", "ret"),
    "_c10d_functional::reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                          "ret"),
}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class CollectiveCensus(TorchDispatchMode):
    """Count the collectives run under it, with this rank's output bytes
    of each: for all-gather the gathered output, for reduce-scatter the
    scattered output, as the reference's census counts them.

        with CollectiveCensus() as census:
            fn(*args)
        census.result()   # {"bytes_by_op", "count_by_op", "total_bytes"}
    """

    def __init__(self):
        super().__init__()
        self.bytes_by_op: dict[str, int] = {}
        self.count_by_op: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        hit = _COLLECTIVES.get(func.name().split(".")[0])
        if hit is not None:
            op, where = hit
            n = _nbytes(args[0] if where == "arg" else out)
            self.bytes_by_op[op] = self.bytes_by_op.get(op, 0) + n
            self.count_by_op[op] = self.count_by_op.get(op, 0) + 1
        return out

    def result(self) -> dict:
        """The reference's census dict."""
        return {"bytes_by_op": dict(self.bytes_by_op),
                "count_by_op": dict(self.count_by_op),
                "total_bytes": sum(self.bytes_by_op.values())}
