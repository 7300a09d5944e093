"""repro_torch — the LeapGNN reproduction on PyTorch and CUDA.

A second package beside :mod:`repro` (the JAX reference). It mirrors the
reference's module paths and names, imports ``torch`` and numpy, and
imports nothing of JAX or of ``repro``: every host module it needs is its
own copy. Entry points run on ``cuda`` by default and raise when no GPU is
present, unless the caller passes ``device="cpu"``.

Slice 1 is the GNN serving path (``serve.GNNServer``), slice 2 the RWKV6
serving path (``launch.serve.LLMServer``), slice 3 LeapGNN training
(``train.Trainer``), slice 4 its checkpoints (``checkpoint``), the
precomputed serving tier (``serve.embeddings``), ``resilience`` and
``membership``; see ROADMAP.md for the modules still to come.
"""
