"""Set-up: process start to the first timed operation (s), less the kernels' build (``compile_s``, reported apart)."""

def read(rec):
    return rec["setup_s"]
