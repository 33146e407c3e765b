"""``repro_torch`` — the PyTorch/CUDA port of the MPipeMoE reproduction.

A second package beside the JAX reference ``repro``. It imports
``torch``, numpy and the standard library, never ``jax`` and nothing of
``repro``: what it needs from there it keeps as its own copy. The layout
mirrors ``repro``'s, so each module's counterpart is found by path:

``configs/``          the config dataclasses and the paper's MoE models
``models/``           spec-tree params, paged KV pools, blocks, the LM
``models/layers/``    norm, embedding, dense FFN, attention
``moe/``              router, dispatch/combine, expert FFNs, the layer
``core/``             the pipelined (n-chunk) MoE and its memory-reuse
                      strategies S1-S4
``kernels/``          hand-written CUDA kernels, their builder, wrappers
                      and plain PyTorch versions
``optim/``, ``data/`` AdamW and the LR schedule; synthetic tokens
``runtime/``          the training step and loop
``serve/``            continuous-batching engine over paged KV
``launch/``           command-line entry points (train, serve)
``convert.py``        JAX parameter tree (as numpy) -> the port's params
"""
