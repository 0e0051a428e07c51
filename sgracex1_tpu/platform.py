"""Where a kernel runs: compiled on a GPU, interpreted on the CPU, or not at all.

The one place the package asks which backend JAX is on. Pallas kernels run
compiled on an NVIDIA GPU (the Triton route); on the CPU they run in the
Pallas interpreter, which is for tests only. A kernel that has no GPU
lowering raises on a GPU instead of falling back to the interpreter, and
any other backend raises: a silent interpreter run on an accelerator would
be orders of magnitude slower than the plain XLA path.
"""

from __future__ import annotations

import jax


def backend() -> str:
    """JAX's default backend name (``"gpu"``, ``"cpu"``, ...)."""
    return jax.default_backend()


def on_gpu() -> bool:
    return backend() == "gpu"


def kernel_interpret(
    platform: str | None = None, *, gpu_lowering: bool = True
) -> bool:
    """``interpret=`` for a ``pallas_call`` on ``platform`` (default: the
    current backend): True on the CPU, False on a GPU when the kernel has
    a GPU lowering. Raises otherwise."""
    platform = platform or backend()
    if platform == "cpu":
        return True
    if platform == "gpu":
        if not gpu_lowering:
            raise NotImplementedError(
                "this kernel has no GPU lowering; use the plain XLA path"
            )
        return False
    raise RuntimeError(
        f"no kernel route for backend {platform!r}: Pallas kernels run "
        "compiled on a GPU or interpreted on the CPU"
    )
