"""Hopper counterparts of the TPU microbenchmarks under the repository's
``tools/``: each module keeps its TPU tool's file name and command line,
makes the same seeded inputs, and runs its kernel (ops/cuda/<tool>.py) on
the card, or its plain version with ``--device cpu``:

    python -m of_spmm_tpu_torch.tools.microbench_blockfma [A] [B]
    python -m of_spmm_tpu_torch.tools.microbench_mxu [S] [variants]
    python -m of_spmm_tpu_torch.tools.microbench_cond
    python -m of_spmm_tpu_torch.tools.proto_fused [R T S TILES] [--check] [--modes=...]
    python -m of_spmm_tpu_torch.tools.microbench_gather [stream xla vmem take onehot block dma]
    python -m of_spmm_tpu_torch.tools.microbench_gather2 [vtake onehot_small onehot_pair
        take_fused dma_deep xla_fused window twosided]
    python -m of_spmm_tpu_torch.tools.microbench_dyngather [tala_eq tala_ne tala_bcast
        perlane vmem_cap]

Each takes ``--device cpu`` to run the plain versions on the host.
"""
