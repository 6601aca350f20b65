"""The attention calls' least time over their device time, in %: the
bound of each batch's K1 prefill (12 calls) and K4 beam steps (12 a
step, gen_len 0..T-2; ``work.decode_step_ms``) over the summed time of
every kernel named as an attention implementation: the port's and
PyTorch SDPA's flash, memory-efficient and cuDNN kernels."""

from benchmarks.harness import kernel_time_ms

ATTENTION = ("attention", "fmha", "flash", "sdpa")


def read(record):
    if not record.get("profiled_steps"):
        return None
    spent = kernel_time_ms(record["trace"], ATTENTION)
    return 100.0 * record["attn_bound_ms"] / spent if spent else None
