"""The attention calls' least time over their device time, in %: the
bound of each K1 (dropout) forward and K2 backward of the profiled steps
(``work.attention_fwd_ms`` / ``attention_bwd_ms`` from the cell's shapes
and each batch's masks, 12 calls of each a step) over the summed time of
every kernel named as an attention implementation: the port's and
PyTorch SDPA's flash, memory-efficient and cuDNN kernels."""

from benchmarks.harness import kernel_time_ms

ATTENTION = ("attention", "fmha", "flash", "sdpa")


def read(record):
    if not record.get("profiled_steps"):
        return None
    spent = kernel_time_ms(record["trace"], ATTENTION)
    return 100.0 * record["attn_bound_ms"] / spent if spent else None
