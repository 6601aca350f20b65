"""Device ms per optimizer step in kernels that are neither matrix
products nor attention: LayerNorm, GELU, dropout, casts, copies, the
loss and the optimizer's elementwise work."""

from benchmarks.harness import kernel_time_ms

# substrings of kernel names (lower case)
MATMUL = ("gemm", "xmma", "cutlass", "nvjet", "gemv", "splitkreduce",
          "cublas")
ATTENTION = ("attention", "fmha", "flash", "sdpa")


def read(record):
    steps = record.get("profiled_steps")
    if not steps:
        return None
    return kernel_time_ms(record["trace"], ("",),
                          exclude=MATMUL + ATTENTION) / steps
