"""The check that a run loads neither JAX nor the JAX package, by whole
top-level module names."""

from benchmark.harness import banned_modules


def test_accepts_the_port():
    assert banned_modules(["han_tpu_torch", "han_tpu_torch.ops.flash_gat", "torch",
                           "benchmark.harness", "numpy", "jaxtyping_like"]) == []


def test_rejects_jax_and_the_jax_package():
    assert banned_modules(["han_tpu"]) == ["han_tpu"]
    assert banned_modules(["han_tpu.graph.containers", "torch"]) == ["han_tpu"]
    assert banned_modules(["jax.numpy"]) == ["jax"]
    assert banned_modules(["jaxlib.xla_client", "flax.linen"]) == ["flax", "jaxlib"]
