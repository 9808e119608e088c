"""PyTorch/CUDA port of the JAX model stack in ``repro``, for one NVIDIA
H100 (Hopper, ``sm_90a``).

The JAX package ``repro`` stays the reference; this package imports
``torch`` and never ``jax`` nor anything of ``repro``.  It mirrors the
reference's layout (``configs``, ``models``, ``kernels``, ``optim``,
``checkpoint``, ``data``, ``runtime``, ``launch``) so each function has
a counterpart there, and keeps the JAX parameter tree's key paths so
weights map 1:1 (:mod:`repro_torch.convert`).

Every constructor and entry point takes ``device`` and defaults to
``"cuda"``; CPU runs must ask for ``device="cpu"``.  On CUDA tensors
attention runs the hand-written Hopper kernels in
``kernels/csrc/flash_attention.cu`` (forward for prefill and training,
backward for training) and the RWKV recurrence those in
``kernels/csrc/rwkv_wkv.cu``; on CPU tensors the same functions run
plain PyTorch, so the CPU tests can hold them against the JAX code.

Importing this package starts no thread, touches no GPU and builds no
kernel: kernels are compiled at their first launch.
"""
