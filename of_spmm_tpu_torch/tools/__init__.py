"""Hopper counterparts of the TPU microbenchmarks under the repository's
``tools/``: each module keeps its TPU tool's file name and command line,
makes the same seeded inputs, and runs its kernel (ops/cuda/<tool>.py) on
the card, or its plain version with ``--device cpu``:

    python -m of_spmm_tpu_torch.tools.microbench_blockfma [A] [B]
    python -m of_spmm_tpu_torch.tools.microbench_mxu [S] [variants]
    python -m of_spmm_tpu_torch.tools.microbench_cond
    python -m of_spmm_tpu_torch.tools.proto_fused [R T S TILES] [--check] [--modes=...]
"""
