"""PyTorch/CUDA port of the ``repro`` package, for NVIDIA Hopper GPUs.

The same layout and names as ``repro`` (``configs``, ``kernels``,
``models``, ``core``, ``sched``, ``launch``), so each module's counterpart
is easy to find.  It imports ``torch`` and never ``jax``, and nothing of
``repro``: what it needs of the framework-free scheduling core is copied.
Entry points run on the CUDA device unless given ``device="cpu"``, where
every kernel wrapper runs its plain PyTorch version.
"""
