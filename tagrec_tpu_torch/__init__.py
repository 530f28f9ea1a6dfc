"""tagrec_tpu_torch — the PyTorch/CUDA port of tagrec_tpu for NVIDIA Hopper.

The JAX package ``tagrec_tpu`` stays the reference; this package imports
nothing from it.  Slice 1: DGCF inference -> serving export -> top-k
retrieval, with the factor-routing kernels written in CUDA C++ (``csrc/``).
Slice 2: KGAT ``bi_inter`` serving and training (BPR + TransE under one
Adam) on the dense flash tier, with the four two-segment flash-attention
kernels in CUDA C++.
Slice 3: LightGCN training, evaluation and serving on the ELL formats of
``ops.ell`` (dense sectors within the dense budget, hybrid hub block + ELL
buckets above it), with the row gather and the ELL gather-reduce kernels in
CUDA C++.
Slice 4: DGCF and DisenGCN training on the dense routing tier.
Slice 5: the training CLI (``python -m tagrec_tpu_torch.cli``) over the four
families, with train-state resume, the JSONL metrics stream and profiling
(``utils``), and the offline preprocessing (``data.preprocess``).
Slice 6: NGCF on every constant-adjacency tier (its asymmetric pair runs
the gather kernels over its own transpose tables), bf16 dense adjacencies
and edge dropout, the chunked dense tier (``adj_mode="dense_xla"``,
``ops.dense_adj``) for DGCF, DisenGCN and KGAT, and DisenHAN in dense
mode.
The parallel layer (``parallel``): a (data, model) mesh of torch.distributed
ranks, row-sharded embedding tables, data-parallel steps (inside the
captured graph on NCCL), the distributed top-k and sharded evaluation,
sharded train states in JAX's layout, and the CLI's ``--dp``/``--mp``.
Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, where every kernel wrapper runs its plain PyTorch version.
"""
