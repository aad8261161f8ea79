"""PyTorch / CUDA port of the integer (DFX) fine-tuning and serving system.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``kernels/``, ``models/``, ``configs/``, ``serve/``, ``launch/``)
so each module's counterpart is found under the same name.  It imports
``torch`` and numpy only — never ``jax`` and never ``repro``.

Every TPU kernel on a ported path is a CUDA C++ kernel written for Hopper
(``csrc/*.cu``, built at first use into ``build/``).  Each kernel wrapper in
``kernels/`` launches the kernel for a CUDA tensor and runs the kernel's
plain PyTorch version only for a tensor that lies on the CPU.
"""
