"""The JAX check compares whole top-level names."""
import pytest

from guard import forbidden_modules


@pytest.mark.parametrize("name", ["vision_processor_tpu_torch", "vision_processor_tpu_torch.x",
                                  "jaxtyping", "jax_utils", "numpy"])
def test_passes(name):
    assert forbidden_modules([name]) == []


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib", "jaxlib.x", "flax",
                                  "vision_processor_tpu", "vision_processor_tpu.x"])
def test_fails(name):
    assert forbidden_modules([name]) == [name]
