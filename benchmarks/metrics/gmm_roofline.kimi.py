"""The grouped expert products' least time over their device time, in %:
the bound of each MoE layer's gate-up and down products, forward and
backward, from the rows the held experts took in the profiled steps
(``work_kimi.expert_products_ms``), over the summed time of the grouped
GEMM kernels (``torch._grouped_mm``'s CUTLASS kernels, named for their
grouped problem shape)."""

from benchmarks.harness import kernel_time_ms

GROUPED = ("groupproblemshape", "grouped")


def read(record):
    if not record.get("gmm_bound_ms"):
        return None
    spent = kernel_time_ms(record["trace"], GROUPED)
    return 100.0 * record["gmm_bound_ms"] / spent if spent else None
