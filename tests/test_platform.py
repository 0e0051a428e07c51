"""The one place the package decides where a kernel runs
(sgracex1_tpu/platform.py): compiled on a GPU, interpreted on the CPU,
an error anywhere else."""

import jax
import pytest

from sgracex1_tpu import platform


def test_cpu_interprets():
    assert platform.kernel_interpret("cpu") is True


def test_gpu_compiles():
    assert platform.kernel_interpret("gpu") is False


def test_gpu_without_lowering_raises():
    with pytest.raises(NotImplementedError, match="no GPU lowering"):
        platform.kernel_interpret("gpu", gpu_lowering=False)


def test_cpu_interprets_even_without_gpu_lowering():
    assert platform.kernel_interpret("cpu", gpu_lowering=False) is True


@pytest.mark.parametrize("name", ["rocm", "METAL", "neuron", "sycl"])
def test_other_backends_raise(name):
    with pytest.raises(RuntimeError, match="no kernel route"):
        platform.kernel_interpret(name)


def test_default_is_current_backend():
    assert platform.backend() == jax.default_backend() == "cpu"
    assert platform.on_gpu() is False
    assert platform.kernel_interpret() is True
